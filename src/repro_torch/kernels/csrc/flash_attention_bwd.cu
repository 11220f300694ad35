// Backward of K1 (flash prefill attention) for Hopper (sm_90a), float32 and
// bfloat16.
//
// It replaces no TPU kernel: the reference trains by differentiating its XLA
// attention (src/repro/models/attention.py::chunked_attention, the function
// the Pallas TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// computes, which has no backward); the port's model path runs K1 in every
// attention layer, so the gradient of K1's function needs a kernel of its
// own.  It takes what the forward (flash_attention.cu: the float32
// flash_fwd_f32_mma_kernel or the bf16 flash_fwd_wgmma_kernel, each given an
// lse pointer) leaves: q, k, v, o and the row log-sum-exp lse [B, H, S]
// (float32 in both) of the scaled, soft-capped, masked scores, and the
// output gradient dO, all in the model layout (q [B, S, H, DQK], o, dO
// [B, S, H, DV], k [B, S, KV, DQK], v [B, S, KV, DV]), and writes dQ, dK, dV
// in the layouts and the dtype of q, k, v.  It recomputes the probabilities
// from lse instead of storing the S x S matrix:
//
//   s  = scale (q . k)                      raw score, over DQK
//   sc = cap tanh(s / cap)  (or s)          soft-capped score
//   P  = exp(sc - lse) where the mask keeps (causal, window, ragged S), else 0
//   D  = rowsum(dO o O)                     one number a query row, over DV
//   dV = P^T dO,   dP = dO V^T (over DV),   dS = P (1 - tanh^2(s / cap)) (dP - D)
//   dQ = scale dS K,   dK = scale dS^T q
//
// with dK and dV summed over the G = H / KV query heads that read one KV head
// (GQA).  Instances: DQK = DV in {8, 16, 32, 64, 128, 256} and MLA's
// (DQK, DV) = (192, 128) and (24, 16), the pairs the forward builds, each in
// float32 and in bf16.
//
// What bounds it: the five products of the causal pairs (s and dK, dQ over
// DQK; dP and dV over DV: 6 DQK + 4 DV operations a pair), against q, k, v,
// o, dO and lse read once and dq, dk, dv written once:
// - Llama-3-8B's training shape (B=2, S=512, H=32, KV=8, 128): 10.76 GFLOP;
//   float32-accurate, 161 us at the 67 TFLOP/s of the CUDA cores, or 3 x
//   10.76 / 495 TFLOP/s = 65 us as 3xTF32 on the tensor cores, against 84.0
//   MB (25 us at 3.35 TB/s); in bf16, 10.9 us at 989 TFLOP/s, against 42.1
//   MB (12.6 us): the bytes bound the bf16 instance.
// - Gemma-2-9B's (B=2, S=512, H=16, KV=8, 256; windows 4,096 and 0 both
//   wider than S): 10.76 GFLOP, 65 us as 3xTF32; 100.7 MB, 30 us (bf16:
//   10.9 us of products, 50.4 MB, 15 us).
// - RecurrentGemma-9B's attention (B=2, S=512, H=16, KV=1, 256, window
//   2,048): 10.76 GFLOP, 65 us; 71.3 MB, 21 us (bf16: 10.9 us of products,
//   35.7 MB, 10.7 us).
// - DeepSeek-V2-Lite's MLA (B=2, S=512, H=KV=16, 192 / 128): 6.99 GFLOP,
//   42 us; 84.0 MB, 25 us (bf16: 7.1 us of products, 42.0 MB, 12.5 us).
//
// float32: why 3xTF32 and not TF32: one TF32 product keeps 10 mantissa bits
// and misses the float32 gradient tolerance (1e-4 of the largest gradient)
// by 2-4x; the split of each operand into big + small TF32 parts
// (tf32x3.cuh) keeps close to float32 accuracy at a third of the TF32 rate,
// 2.5x the CUDA-core rate.  Why mma.sync and not wgmma for float32: wgmma
// takes TF32 operands only K-major from shared memory (only 16-bit types may
// be transposed), and the five products read q, k, dO, P and dS in both
// orientations (s and dP reduce over the head dims, dV and dK over queries,
// dQ over keys); mma.sync fragments are loaded by each thread in either
// orientation, and the float32 splits are made in registers.
//
// float32 design.  Four launches:
// - flash_bwd_dot_kernel: D in float32, one warp a row.
// - flash_bwd_dkdv_kernel: one block per work item (b, query head h, 64-key
//   tile), from the wrapper's work table (heads = 1), longest first; it walks
//   the query tiles that can see its keys and keeps dK, dV of its 64 keys in
//   registers.  Items of one KV head's G query heads write float32 partials
//   to the scratch (dK's [G, B, S, KV, DQK], then dV's [G, B, S, KV, DV]; at
//   G = 1 straight to dk, dv).
// - flash_bwd_sum_kernel (G > 1): dK, dV = the partials summed in the order
//   g = 0 .. G - 1, then stored.
// - flash_bwd_dq_kernel: one block per (batch * head, 64-row query tile),
//   the longest rows first under a causal mask; it walks the key tiles its
//   rows can see and keeps dQ in registers.
// With SPLIT = 1 a block is four warps, each owning 16 rows (keys, or
// queries) of the 64 and all columns of the step, so P and dS go from the
// accumulators of s and dP straight into the A fragments of the next
// products (tf32x3.cuh: the reduction slots are permuted to match), never
// through shared memory.  With SPLIT = 2 a block is eight warps and two
// share 16 rows, by role: in the dK/dV kernel warp w < 4 computes s and P
// and keeps dV, warp w + 4 computes dP and dS and keeps dK; the first hands
// P (1 - tanh^2) to the second through 2 KB of shared memory a pair, laid
// out as the fragments are (each lane reads back the 16 values it would have
// held), at one 64-thread named barrier a step.  In the dQ kernel the pair
// splits s (warp w) from dP (warp w + 4), trades P (1 - tanh^2) and dP the
// same way, and each warp forms dS and keeps half of dQ's columns.  The
// other way to fit, two passes of dK/dV by column halves each recomputing s
// and dP, does 9 products a pair where this does 7, with half the warps.
// float32 takes pairs at hd 256 only (kernel_ab.py against builds of this
// file with n_split changed; NVIDIA H100 80GB HBM3, 700.00 W, PERF.md: one
// warp holding both spills over 2 KB a thread and runs about 1.4x slower;
// at (192, 128) and 128 one warp is faster).
// Tiles are row-major in shared memory, rows DQK + 4 and DV + 4 floats (4 x
// an odd number, mod 32: 12, 20, 28, 36, 68, 132, 196, 260), so the 32
// lanes of every fragment load hit 32 banks, whether it reads along rows or
// down columns.  The streamed tiles (q and dO, or k and v) come 32 rows a
// step by 16-byte cp.async: where a head dim reaches 128 in one stage (at
// DQK = DV = 128 a block takes 101,632 bytes (dK/dV) or 101,376 (dQ) and two
// blocks share an SM, one's copies overlapping the other's products; at
// (192, 128) 126,208 and 125,952, at 256 208,128 and 216,064, one block an
// SM), below it in two stages, the next step's copy overlapping this step's
// products.  Steps whose every pair the mask keeps skip the mask.
//
// bfloat16 (training, as the reference trains): every product is wgmma
// (m64nNk16, bf16 operands, float32 accumulators) from 128-byte-swizzled
// shared-memory tiles (sm90.cuh's sw128 layout, the forward's), the
// forward's design carried to the five products:
// - flash_bwd_dkdv_wgmma_kernel: a warpgroup owns the item's 64 keys
//   (wgmma's M).  s^T = k q^T and dP^T = v dO^T are shared x shared
//   products, both operands K-major (k and v resident, q and dO streamed);
//   P^T and dS^T go from their float32 accumulators, rounded to bf16, into
//   the register A operand of dV += P^T dO and dK += dS^T q, which read dO
//   and q MN-major (bf16 may be transposed, TF32 may not), as the forward
//   feeds P into P V.  lse and D of the step's 64 queries come with its
//   tiles.
// - flash_bwd_dq_wgmma_kernel: a warpgroup owns 64 query rows.  s = q k^T
//   and dP = dO v^T are shared x shared; dQ += dS k takes dS from registers
//   and reads k MN-major.
// - flash_bwd_dot_bf16_kernel: D, 16 bytes of o and dO a thread.
// - Work items: one per (b, group of ``heads`` query heads of one KV head,
//   64-key tile) (the wrapper's bwd_work_table); the item walks its heads'
//   query tiles, one 64-row step each (heads x query tiles steps), and sums
//   dK and dV in registers in the order of its heads.  Only the G / heads
//   groups write float32 partials, which flash_bwd_sum_kernel adds in a fixed
//   order; with one group (heads = G) the item stores dk, dv in bf16.  The
//   wrapper picks heads (bwd_heads_per_item): the most a group that still
//   leaves 132 items.  Measured (kernel_ab.py --sweep; NVIDIA H100 80GB
//   HBM3, 700.00 W, PERF.md): at Llama-3-8B's training shape 2 heads an
//   item (256 items) beat 1 (512 items, twice the partials) and 4 (128
//   items, no partials: the causal imbalance leaves SMs idle).
// - Each step, 64 rows (wgmma's N of s^T, and the k-steps of dV and dK),
//   streams through a ring of two stages of 16-byte cp.async copies into
//   sw128 tiles.  The products of a step are two commit groups, so P^T is
//   formed while dP^T runs and dS^T while dV runs, and the step's dV and dK
//   (dQ) still run when the next step's s^T and dP^T are issued; the next
//   step's copies are issued once s^T retires (which retires the last
//   step's products, the only readers of that stage): one more barrier a
//   step.  The softmax loops take the soft-cap and the mask as template
//   arguments, so a step's 32 scores a thread carry no branch and their exp
//   chains overlap (with a runtime branch on the cap inside the loop the
//   chains ran one after another and the softmax took most of a step), and
//   the loader's trip count is a constant with each thread's addresses
//   computed once (a runtime-bounded loop spent about 25 instructions of
//   address arithmetic and branches a copy).  TMA (cp.async.bulk.tensor
//   with mbarriers) and a producer warp were not tried.
// - Roles: where one warpgroup cannot hold its keys' dK and dV beside s^T and
//   dP^T in registers (dK/dV kernel at DQK + DV > 256: (192, 128) needs 96 +
//   64 + 32 + 32 floats a thread, 256 needs 128 + 128 + 64), two warpgroups
//   own the same 64 keys by role: the first computes s^T and P^T and keeps
//   dV, the second dP^T and dS^T and keeps dK; the first hands P (1 -
//   tanh^2) (float32, 16 KB laid out as the accumulators are) to the second
//   at one named barrier a step (bar.arrive by the first, bar.sync by the
//   second).  In the dQ kernel at DQK = 256 (dQ alone is 128 floats a
//   thread) the first computes s and P (1 - tanh^2), the second dP, they
//   trade them through 32 KB, and each forms dS and keeps half of dQ's
//   columns.  Nothing is computed twice.  The rule is the register count
//   (224 accumulator floats a thread at (192, 128), 320 at 256, where one
//   warpgroup of the dK/dV kernel would spill; 192 in the dQ kernel at
//   256); it was not timed against one-warpgroup builds in this design.
// - Head dims under 16 columns, and 24, are zero-filled to wgmma's k-step of
//   16 (exact for the products that reduce over them); a tile is stored in
//   panels of 64 columns, and the output columns past the head dim are
//   dropped.  At 256 the dK/dV block takes 215,040 bytes of shared memory and
//   the dQ block 230,400; at 128, 100,352 and 99,328 (two blocks an SM).
// P and dS are rounded to bf16 only as operands of their products, as the
// forward rounds P (the reference's attention rounds P to the value dtype
// before P V); the soft-cap's (1 - tanh^2), lse and D stay float32, and dq,
// dk, dv are rounded to bf16 once, when stored.
//
// Both types: s and dP are recomputed by both the dK/dV and the dQ kernels
// (seven products, not five): the price of writing each output once.  Every
// output element is written once after a sum in a fixed order (the tensor
// cores' own within a product, the partials' in the sum kernel): no float
// atomics, so two runs give the same bits.  Tiles the causal or window mask
// rules out whole are never loaded.

#include <stdint.h>

#include <cuda_runtime.h>

#include "common.cuh"
#include "sm90.cuh"
#include "tf32x3.cuh"

namespace {

namespace sm90 = repro_torch::sm90;
namespace tf32x3 = repro_torch::tf32x3;
using bf16 = __nv_bfloat16;
using repro_torch::to_f32;

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // keys per tile
constexpr int ITEM = 5;         // work-table row: b, h, key tile, first and end query tile

// float32: the streamed tiles (q and dO in the dK/dV kernel, k and v in the
// dQ kernel) come SR = 32 rows a step.  Where a head dim reaches 128 one
// stage keeps a block at 101 KB (DQK = DV = 128), so two blocks share an SM
// and one's copies overlap the other's products; below it two stages fit
// twice.  (Both measured faster than 64-row steps in two stages, at
// Llama-3-8B's training shape and at the quickstart's hd 64, while the
// float32 kernel was designed.)
constexpr int SR = 32;
constexpr int NJ = SR / 8;      // 8-row blocks of a step's scores
constexpr int XCH = NJ * 4 * 32;  // floats of one warp's 16 x SR scores, as fragments

// The products of one storage type, as the kernels call them: d (16 x 8,
// float32) += a (16 x K) b (K x 8).  Tiles in shared memory are row-major,
// width(D) + PAD elements a row.
//   load_a(t, ld, r0, c0):   A = rows r0 .. r0 + 15, columns c0 .. c0 + K - 1
//   load_b_t(t, ld, n0, c0): B = (rows n0 .. n0 + 7, columns c0 .. c0 + K - 1)^T
//                            (the reduction runs along the tile's rows)
//   load_b(t, ld, k0, n0):   B = rows k0 .. k0 + K - 1, columns n0 .. n0 + 7
//                            (read down the tile's columns), its reduction
//                            slots those that acc_as_a leaves
//   acc_as_a(c, j):          the accumulators c[j] .. c[j + K / 8 - 1] (16 rows,
//                            K columns) as the A operand of a product that
//                            reduces over those columns, in registers
template <typename T>
struct Mma;

// float32: 3xTF32 mma.sync.m16n8k8 (tf32x3.cuh), K = 8; row stride D + 4
// floats (4 x an odd number, mod 32), so the 32 lanes of every fragment
// load hit 32 banks, whether it reads along rows or down columns
template <>
struct Mma<float> {
  static constexpr int K = 8;
  static constexpr int PAD = 4;
  using A = tf32x3::Split<4>;
  using B = tf32x3::Split<2>;
  __host__ __device__ static constexpr int width(int d) { return d; }
  __device__ static A load_a(const float* t, int ld, int r0, int c0, int lane) {
    return tf32x3::load_a(t, ld, r0, c0, lane);
  }
  __device__ static B load_b_t(const float* t, int ld, int n0, int c0, int lane) {
    return tf32x3::load_b_t(t, ld, n0, c0, lane);
  }
  __device__ static B load_b(const float* t, int ld, int k0, int n0, int lane) {
    return tf32x3::load_b_perm(t, ld, k0, n0, lane);
  }
  template <int N>
  __device__ static A acc_as_a(const float (&c)[N][4], int j) {
    return tf32x3::acc_as_a(c[j]);
  }
  __device__ static void mma(float (&d)[4], const A& a, const B& b) {
    tf32x3::mma3(d, a, b);
  }
};

// float32 warps that share 16 rows: 2 (by role) where one warp cannot hold
// dK and dV, chosen by measurement (see the header): at hd 256
template <int DQK>
__host__ __device__ constexpr int n_split() {
  return DQK > 192 ? 2 : 1;
}

// one float32 instance's shape: head dims as stored, row strides, warps,
// stages, shared memory (bytes)
template <typename T, int DQK, int DV>
struct Bwd {
  static constexpr int DQP = Mma<T>::width(DQK), DVP = Mma<T>::width(DV);
  static constexpr int RQ = DQP + Mma<T>::PAD, RV = DVP + Mma<T>::PAD;
  static constexpr int KMAX = DQP > DVP ? DQP : DVP;
  static constexpr int SPLIT = n_split<DQK>();
  static constexpr int NT = 128 * SPLIT;
  static constexpr int NST = DQK < 128 && DV < 128 ? 2 : 1;
  // dK/dV: k, v; the stages of q, dO, lse, D; the pairs' exchange
  static constexpr size_t KV_STAGE = sizeof(T) * SR * (RQ + RV) + sizeof(float) * 2 * SR;
  static constexpr size_t KV_SMEM = sizeof(T) * BK * (RQ + RV) + NST * KV_STAGE +
                                    sizeof(float) * (SPLIT - 1) * 4 * XCH;
  // dQ: q, dO; the stages of k, v; the pairs' exchange
  static constexpr size_t Q_STAGE = sizeof(T) * SR * (RQ + RV);
  static constexpr size_t Q_SMEM = sizeof(T) * BQ * (RQ + RV) + NST * Q_STAGE +
                                   sizeof(float) * (SPLIT - 1) * 8 * XCH;
  static_assert(KV_SMEM <= 232448 && Q_SMEM <= 232448,
                "over the shared memory a block may use");
  static_assert(DQK % 8 == 0 && DV % 8 == 0 && DQK / 8 % SPLIT == 0, "instance shape");
};

__device__ __forceinline__ bool live(int qp, int kp, int S, int causal, int window) {
  return qp < S && kp < S && (!causal || kp <= qp) &&
         (window <= 0 || kp > qp - window);
}

// P and P (1 - tanh^2) of one score: ``s`` the raw score (scaled q . k),
// ``l`` the row's lse; dS = w (dP - D)
__device__ __forceinline__ void prob(float s, float l, bool ok, float logit_cap,
                                     float* p, float* w) {
  float dcap = 1.f;
  if (logit_cap > 0.f) {
    const float t = tanhf(s / logit_cap);
    s = logit_cap * t;
    dcap = 1.f - t * t;
  }
  *p = ok ? expf(s - l) : 0.f;
  *w = *p * dcap;
}

// the two warps that share 16-row group ``grp`` (SPLIT = 2) meet
__device__ __forceinline__ void pair_sync(int grp) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + grp) : "memory");
}

// rows row0 .. row0 + ROWS - 1 of a D-wide row-major array (rows ``stride``
// elements apart, S of them) -> a tile of width(D) + PAD elements a row, by
// 16-byte cp.async from NT threads; rows past S and the columns from D to
// width(D) are zero-filled
template <typename T, int D, int ROWS, int NT>
__device__ __forceinline__ void load_tile(T* dst, const T* src, size_t stride,
                                          int row0, int S, int tid) {
  constexpr int E = 16 / sizeof(T);               // elements of one copy
  constexpr int W = Mma<T>::width(D), CH = W / E, RS = W + Mma<T>::PAD;
  static_assert(D % E == 0 && W % E == 0, "rows of whole 16-byte copies");
#pragma unroll 4
  for (int i = tid; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = i % CH, s = row0 + r;
    const bool ok = s < S && c * E < D;
    sm90::cp_async16(sm90::smem_addr(dst + r * RS + E * c),
                     src + (ok ? (size_t)s * stride + E * c : 0), ok);
  }
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<uint32_t*>(p) = sm90::pack_bf16(x, y);
}

// one 16 x 8 accumulator times f to rows lo and hi (``row`` elements apart)
// at columns c, c + 1 (bf16: rounded once, here); rows past S are not written
template <typename O>
__device__ __forceinline__ void store_acc(O* base, size_t row, int lo, int hi,
                                          int S, int c, const float (&a)[4],
                                          float f) {
  if (lo < S) store2(base + lo * row + c, a[0] * f, a[1] * f);
  if (hi < S) store2(base + hi * row + c, a[2] * f, a[3] * f);
}

// D[b, h, s] = sum_c dO[b, s, h, c] O[b, s, h, c] in float32, one warp a
// (b, s, h) row
template <typename T>
__global__ void flash_bwd_dot_kernel(const T* __restrict__ o,
                                     const T* __restrict__ dout,
                                     float* __restrict__ delta, int rows, int S,
                                     int H, int DV) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* orow = o + (size_t)row * DV;
  const T* drow = dout + (size_t)row * DV;
  float acc = 0.f;
  for (int c = lane; c < DV; c += 32) acc = fmaf(to_f32(orow[c]), to_f32(drow[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = row % H;
    const int s = (row / H) % S;
    const int b = row / (H * S);
    delta[((size_t)b * H + h) * S + s] = acc;
  }
}

// one block: one work item (b, query head h, 64-key tile); warp w owns keys
// 16 (w % 4) .. 16 (w % 4) + 15 of the tile (at SPLIT = 2 warps w and w + 4,
// dV and dK).  Writes scale dS^T q and P^T dO of its keys to pk, pv at
// [g, b, s, kvh, :] (g = h % G; at G = 1 these are dk, dv): float32 where
// f32_out, else T.
template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(Bwd<T, DQK, DV>::NT)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const int* __restrict__ items, void* __restrict__ pk,
                      void* __restrict__ pv, int f32_out, int B, int S, int H,
                      int KV, int causal, int window, float logit_cap,
                      float scale) {
  using C = Bwd<T, DQK, DV>;
  using M = Mma<T>;
  constexpr int RQ = C::RQ, RV = C::RV;   // row strides of the q/k and v/dO tiles
  constexpr int NST = C::NST, SPLIT = C::SPLIT, NT = C::NT;
  constexpr int NK = DQK / 8, NV = DV / 8;  // 8-column blocks of dK, dV
  // SPLIT = 1: dK in acc, dV in acc_v; SPLIT = 2: this warp's dV (role 0) or dK in acc
  constexpr int NA = SPLIT == 1 ? NK : (NK > NV ? NK : NV);
  constexpr int NB = SPLIT == 1 ? NV : 1;
  extern __shared__ __align__(16) uint8_t smem[];
  T* Ks = reinterpret_cast<T*>(smem);     // [BK][RQ]
  T* Vs = Ks + BK * RQ;                   // [BK][RV]
  // NST x {q [SR][RQ], dO [SR][RV], lse [SR] and D [SR] float32}
  uint8_t* stages = reinterpret_cast<uint8_t*>(Vs + BK * RV);
  // SPLIT = 2: [4][XCH], P (1 - tanh^2) a group
  float* xch = reinterpret_cast<float*>(stages + NST * C::KV_STAGE);

  const int* item = items + (size_t)blockIdx.x * ITEM;
  const int b = item[0], h = item[1], k0 = item[2] * BK;
  const int row_begin = item[3] * BQ, row_end = min(S, item[4] * BQ);
  const int n_steps = (row_end - row_begin + SR - 1) / SR;
  const int G = H / KV, kvh = h / G, g = h % G;
  const int tid = threadIdx.x, lane = tid & 31, grp = (tid >> 5) & 3;
  const int role = tid >> 7;              // 0 at SPLIT = 1
  const int r0 = grp * 16;
  const int key_lo = k0 + r0 + (lane >> 2), key_hi = key_lo + 8;
  const int t2 = 2 * (lane & 3);
  const size_t q_row = (size_t)H * DQK, o_row = (size_t)H * DV;  // strides between positions
  const size_t k_row = (size_t)KV * DQK, v_row = (size_t)KV * DV;
  const T* qb = q + ((size_t)b * S * H + h) * DQK;
  const T* db = dout + ((size_t)b * S * H + h) * DV;
  const float* lb = lse + ((size_t)b * H + h) * S;
  const float* deb = delta + ((size_t)b * H + h) * S;

  auto load_q = [&](int step, uint8_t* st) {
    const int q0 = row_begin + step * SR;
    T* qs = reinterpret_cast<T*>(st);
    load_tile<T, DQK, SR, NT>(qs, qb, q_row, q0, S, tid);
    load_tile<T, DV, SR, NT>(qs + SR * RQ, db, o_row, q0, S, tid);
    if (tid < SR) {
      const int s = q0 + tid;
      const bool ok = s < S;
      float* ld = reinterpret_cast<float*>(qs + SR * (RQ + RV));
      sm90::cp_async4(sm90::smem_addr(ld + tid), lb + (ok ? s : 0), ok);
      sm90::cp_async4(sm90::smem_addr(ld + SR + tid), deb + (ok ? s : 0), ok);
    }
  };
  load_tile<T, DQK, BK, NT>(Ks, k + ((size_t)b * S * KV + kvh) * DQK, k_row, k0, S, tid);
  load_tile<T, DV, BK, NT>(Vs, v + ((size_t)b * S * KV + kvh) * DV, v_row, k0, S, tid);
  if (NST == 2 && n_steps > 0) load_q(0, stages);
  sm90::cp_async_commit();

  float acc[NA][4], acc_v[NB][4];
#pragma unroll
  for (int n = 0; n < NA; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_v[n][e] = 0.f;

  for (int step = 0; step < n_steps; ++step) {
    uint8_t* st = stages + (NST == 2 ? (step & 1) * C::KV_STAGE : 0);
    const T* Qs = reinterpret_cast<const T*>(st);
    const T* dOs = Qs + SR * RQ;
    const float* Ls = reinterpret_cast<const float*>(dOs + SR * RV);
    const float* Ds = Ls + SR;
    if (NST == 1) {         // every warp finished the last step's products
      load_q(step, stages);
      sm90::cp_async_commit();
      sm90::cp_async_wait<0>();
    } else if (step + 1 < n_steps) {  // the other stage's readers finished last step
      load_q(step + 1, stages + ((step + 1) & 1) * C::KV_STAGE);
      sm90::cp_async_commit();
      sm90::cp_async_wait<1>();
    } else {
      sm90::cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = row_begin + step * SR;
    // every (query, key) pair of the step live: no mask to evaluate
    const bool full = q0 + SR <= S && k0 + BK <= S &&
                      (!causal || k0 + BK - 1 <= q0) &&
                      (window <= 0 || k0 > q0 + SR - 1 - window);

    if constexpr (SPLIT == 1) {
      // s^T and dP^T: rows keys, columns the step's queries
      float s_acc[NJ][4], dp_acc[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s_acc[j][e] = dp_acc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < C::KMAX; kk += M::K) {
        typename M::A ka, va;
        if (kk < C::DQP) ka = M::load_a(Ks, RQ, r0, kk, lane);
        if (kk < C::DVP) va = M::load_a(Vs, RV, r0, kk, lane);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if (kk < C::DQP) M::mma(s_acc[j], ka, M::load_b_t(Qs, RQ, 8 * j, kk, lane));
          if (kk < C::DVP) M::mma(dp_acc[j], va, M::load_b_t(dOs, RV, 8 * j, kk, lane));
        }
      }
      // P^T and dS^T in place
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + t2 + (e & 1);
          float p, w;
          prob(s_acc[j][e] * scale, Ls[c],
               full || live(q0 + c, e < 2 ? key_lo : key_hi, S, causal, window),
               logit_cap, &p, &w);
          s_acc[j][e] = p;
          dp_acc[j][e] = w * (dp_acc[j][e] - Ds[c]);
        }
      // dV += P^T dO, dK += dS^T q
#pragma unroll
      for (int j = 0; j < NJ; j += M::K / 8) {
        const auto pa = M::acc_as_a(s_acc, j);
        const auto sa = M::acc_as_a(dp_acc, j);
#pragma unroll
        for (int n = 0; n < (NK > NV ? NK : NV); ++n) {
          if (n < NV) M::mma(acc_v[n], pa, M::load_b(dOs, RV, 8 * j, 8 * n, lane));
          if (n < NK) M::mma(acc[n], sa, M::load_b(Qs, RQ, 8 * j, 8 * n, lane));
        }
      }
    } else {
      float x[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
      float* xg = xch + grp * XCH;
      if (role == 0) {      // s^T, then P^T; P (1 - tanh^2) to the pair
#pragma unroll
        for (int kk = 0; kk < C::DQP; kk += M::K) {
          const auto ka = M::load_a(Ks, RQ, r0, kk, lane);
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            M::mma(x[j], ka, M::load_b_t(Qs, RQ, 8 * j, kk, lane));
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * j + t2 + (e & 1);
            float p, w;
            prob(x[j][e] * scale, Ls[c],
                 full || live(q0 + c, e < 2 ? key_lo : key_hi, S, causal, window),
                 logit_cap, &p, &w);
            x[j][e] = p;
            xg[(4 * j + e) * 32 + lane] = w;
          }
      } else {              // dP^T
#pragma unroll
        for (int kk = 0; kk < C::DVP; kk += M::K) {
          const auto va = M::load_a(Vs, RV, r0, kk, lane);
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            M::mma(x[j], va, M::load_b_t(dOs, RV, 8 * j, kk, lane));
        }
      }
      pair_sync(grp);
      if (role == 0) {      // dV += P^T dO
#pragma unroll
        for (int j = 0; j < NJ; j += M::K / 8) {
          const auto pa = M::acc_as_a(x, j);
#pragma unroll
          for (int n = 0; n < NV; ++n)
            M::mma(acc[n], pa, M::load_b(dOs, RV, 8 * j, 8 * n, lane));
        }
      } else {              // dS^T in place of dP^T; dK += dS^T q
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            x[j][e] = xg[(4 * j + e) * 32 + lane] * (x[j][e] - Ds[8 * j + t2 + (e & 1)]);
#pragma unroll
        for (int j = 0; j < NJ; j += M::K / 8) {
          const auto sa = M::acc_as_a(x, j);
#pragma unroll
          for (int n = 0; n < NK; ++n)
            M::mma(acc[n], sa, M::load_b(Qs, RQ, 8 * j, 8 * n, lane));
        }
      }
    }
    __syncthreads();  // every warp is done with this stage and the exchange
  }
  sm90::cp_async_wait<0>();  // an item with no query row still loaded k, v

  const size_t k_off = (size_t)g * B * S * KV * DQK + ((size_t)b * S * KV + kvh) * DQK;
  const size_t v_off = (size_t)g * B * S * KV * DV + ((size_t)b * S * KV + kvh) * DV;
  auto store = [&](void* out, size_t off, size_t row, int n, const float (&a)[4],
                   float f) {
    if (f32_out)
      store_acc(static_cast<float*>(out) + off, row, key_lo, key_hi, S, 8 * n + t2, a, f);
    else
      store_acc(static_cast<T*>(out) + off, row, key_lo, key_hi, S, 8 * n + t2, a, f);
  };
  if constexpr (SPLIT == 1) {
#pragma unroll
    for (int n = 0; n < NK; ++n) store(pk, k_off, k_row, n, acc[n], scale);
#pragma unroll
    for (int n = 0; n < NV; ++n) store(pv, v_off, v_row, n, acc_v[n], 1.f);
  } else if (role == 1) {
#pragma unroll
    for (int n = 0; n < NK; ++n) store(pk, k_off, k_row, n, acc[n], scale);
  } else {
#pragma unroll
    for (int n = 0; n < NV; ++n) store(pv, v_off, v_row, n, acc[n], 1.f);
  }
}

__device__ __forceinline__ void store4(float* p, float4 a) {
  *reinterpret_cast<float4*>(p) = a;
}

__device__ __forceinline__ void store4(bf16* p, float4 a) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(sm90::pack_bf16(a.x, a.y), sm90::pack_bf16(a.z, a.w));
}

// dk, dv = the G float32 partials (pk [G, nk4], pv [G, nv4], 4 floats an
// element) summed in the order g = 0 .. G - 1, then stored as T (bf16:
// rounded once)
template <typename T>
__global__ void flash_bwd_sum_kernel(const float4* __restrict__ pk,
                                     const float4* __restrict__ pv,
                                     T* __restrict__ dk, T* __restrict__ dv,
                                     size_t nk4, size_t nv4, int G) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < nk4) {
    float4 a = pk[i];
    for (int g = 1; g < G; ++g) {
      const float4 x = pk[(size_t)g * nk4 + i];
      a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
    }
    store4(dk + 4 * i, a);
  }
  if (i < nv4) {
    float4 c = pv[i];
    for (int g = 1; g < G; ++g) {
      const float4 y = pv[(size_t)g * nv4 + i];
      c.x += y.x; c.y += y.y; c.z += y.z; c.w += y.w;
    }
    store4(dv + 4 * i, c);
  }
}

// one block: 64 query rows of one (batch, head), the last tile first under a
// causal mask (it walks the most key tiles); warp w owns rows
// 16 (w % 4) .. 16 (w % 4) + 15 (at SPLIT = 2 warps w and w + 4, each half of
// dQ's columns)
template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(Bwd<T, DQK, DV>::NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int S, int H, int KV, int causal, int window,
                    float logit_cap, float scale) {
  using C = Bwd<T, DQK, DV>;
  using M = Mma<T>;
  constexpr int RQ = C::RQ, RV = C::RV;
  constexpr int NST = C::NST, SPLIT = C::SPLIT, NT = C::NT;
  constexpr int NQ = DQK / 8 / SPLIT;     // 8-column blocks of dQ a warp
  extern __shared__ __align__(16) uint8_t smem[];
  T* Qs = reinterpret_cast<T*>(smem);     // [BQ][RQ]
  T* dOs = Qs + BQ * RQ;                  // [BQ][RV]
  T* stages = dOs + BQ * RV;              // NST x {k [SR][RQ], v [SR][RV]}
  // SPLIT = 2: [4][2][XCH], P (1 - tanh^2) and dP
  float* xch = reinterpret_cast<float*>(stages + NST * SR * (RQ + RV));

  const int n_tiles = (S + BQ - 1) / BQ;
  const int b = blockIdx.x / H, h = blockIdx.x % H, kvh = h / (H / KV);
  const int q0 = (causal ? n_tiles - 1 - (int)blockIdx.y : (int)blockIdx.y) * BQ;
  const int tid = threadIdx.x, lane = tid & 31, grp = (tid >> 5) & 3;
  const int role = tid >> 7;              // 0 at SPLIT = 1
  const int r0 = grp * 16, c_off = role * (DQK / SPLIT);
  const int row_lo = q0 + r0 + (lane >> 2), row_hi = row_lo + 8;
  const int t2 = 2 * (lane & 3);
  const size_t q_row = (size_t)H * DQK, o_row = (size_t)H * DV;
  const size_t k_row = (size_t)KV * DQK, v_row = (size_t)KV * DV;
  const T* kb = k + ((size_t)b * S * KV + kvh) * DQK;
  const T* vb = v + ((size_t)b * S * KV + kvh) * DV;
  const float* lb = lse + ((size_t)b * H + h) * S;
  const float* deb = delta + ((size_t)b * H + h) * S;
  const float l_lo = row_lo < S ? lb[row_lo] : 0.f, l_hi = row_hi < S ? lb[row_hi] : 0.f;
  const float d_lo = row_lo < S ? deb[row_lo] : 0.f, d_hi = row_hi < S ? deb[row_hi] : 0.f;

  // the forward's live key tiles
  const int kt_end = causal ? min(n_tiles, (q0 + BQ - 1) / BK + 1) : n_tiles;
  int kt_begin = 0;
  if (window > 0) {
    const int lo = q0 - window - BK + 1;  // live iff kt * BK > lo
    kt_begin = lo < 0 ? 0 : lo / BK + 1;
  }
  const int key_begin = kt_begin * BK, key_end = min(S, kt_end * BK);
  const int n_steps = (key_end - key_begin + SR - 1) / SR;
  auto load_kv = [&](int step, T* st) {
    load_tile<T, DQK, SR, NT>(st, kb, k_row, key_begin + step * SR, S, tid);
    load_tile<T, DV, SR, NT>(st + SR * RQ, vb, v_row, key_begin + step * SR, S, tid);
  };
  load_tile<T, DQK, BQ, NT>(Qs, q + ((size_t)b * S * H + h) * DQK, q_row, q0, S, tid);
  load_tile<T, DV, BQ, NT>(dOs, dout + ((size_t)b * S * H + h) * DV, o_row, q0, S, tid);
  if (NST == 2 && n_steps > 0) load_kv(0, stages);
  sm90::cp_async_commit();

  float dq_acc[NQ][4];
#pragma unroll
  for (int n = 0; n < NQ; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;

  for (int step = 0; step < n_steps; ++step) {
    const T* Ks = stages + (NST == 2 ? (step & 1) * SR * (RQ + RV) : 0);
    const T* Vs = Ks + SR * RQ;
    if (NST == 1) {
      load_kv(step, stages);
      sm90::cp_async_commit();
      sm90::cp_async_wait<0>();
    } else if (step + 1 < n_steps) {
      load_kv(step + 1, stages + ((step + 1) & 1) * SR * (RQ + RV));
      sm90::cp_async_commit();
      sm90::cp_async_wait<1>();
    } else {
      sm90::cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = key_begin + step * SR;
    const bool full = q0 + BQ <= S && k0 + SR <= S &&
                      (!causal || k0 + SR - 1 <= q0) &&
                      (window <= 0 || k0 > q0 + BQ - 1 - window);

    // dS of this warp's rows and the step's keys, in ds
    float ds[NJ][4];
    if constexpr (SPLIT == 1) {
      float dp_acc[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[j][e] = dp_acc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < C::KMAX; kk += M::K) {
        typename M::A qa, oa;
        if (kk < C::DQP) qa = M::load_a(Qs, RQ, r0, kk, lane);
        if (kk < C::DVP) oa = M::load_a(dOs, RV, r0, kk, lane);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if (kk < C::DQP) M::mma(ds[j], qa, M::load_b_t(Ks, RQ, 8 * j, kk, lane));
          if (kk < C::DVP) M::mma(dp_acc[j], oa, M::load_b_t(Vs, RV, 8 * j, kk, lane));
        }
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + 8 * j + t2 + (e & 1);
          const bool lo = e < 2;
          float p, w;
          prob(ds[j][e] * scale, lo ? l_lo : l_hi,
               full || live(lo ? row_lo : row_hi, kp, S, causal, window),
               logit_cap, &p, &w);
          ds[j][e] = w * (dp_acc[j][e] - (lo ? d_lo : d_hi));
        }
    } else {
      // warp w: s, then P (1 - tanh^2); warp w + 4: dP; each hands its
      // values to the other and both form dS
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[j][e] = 0.f;
      float* xg = xch + grp * 2 * XCH;    // [0]: P (1 - tanh^2), [1]: dP
      if (role == 0) {
#pragma unroll
        for (int kk = 0; kk < C::DQP; kk += M::K) {
          const auto qa = M::load_a(Qs, RQ, r0, kk, lane);
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            M::mma(ds[j], qa, M::load_b_t(Ks, RQ, 8 * j, kk, lane));
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = k0 + 8 * j + t2 + (e & 1);
            const bool lo = e < 2;
            float p, w;
            prob(ds[j][e] * scale, lo ? l_lo : l_hi,
                 full || live(lo ? row_lo : row_hi, kp, S, causal, window),
                 logit_cap, &p, &w);
            ds[j][e] = w;
            xg[(4 * j + e) * 32 + lane] = w;
          }
      } else {
#pragma unroll
        for (int kk = 0; kk < C::DVP; kk += M::K) {
          const auto oa = M::load_a(dOs, RV, r0, kk, lane);
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            M::mma(ds[j], oa, M::load_b_t(Vs, RV, 8 * j, kk, lane));
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) xg[XCH + (4 * j + e) * 32 + lane] = ds[j][e];
      }
      pair_sync(grp);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = (4 * j + e) * 32 + lane;
          const float w = role == 0 ? ds[j][e] : xg[i];
          const float dp = role == 0 ? xg[XCH + i] : ds[j][e];
          ds[j][e] = w * (dp - (e < 2 ? d_lo : d_hi));
        }
    }
    // dQ += dS k, over this warp's columns
#pragma unroll
    for (int j = 0; j < NJ; j += M::K / 8) {
      const auto sa = M::acc_as_a(ds, j);
#pragma unroll
      for (int n = 0; n < NQ; ++n)
        M::mma(dq_acc[n], sa, M::load_b(Ks, RQ, 8 * j, c_off + 8 * n, lane));
    }
    __syncthreads();  // every warp is done with this stage and the exchange
  }
  sm90::cp_async_wait<0>();

  T* dqb = dq + ((size_t)b * S * H + h) * DQK;
#pragma unroll
  for (int n = 0; n < NQ; ++n)
    store_acc(dqb, q_row, row_lo, row_hi, S, c_off + 8 * n + t2, dq_acc[n], scale);
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma from sw128 tiles
// ---------------------------------------------------------------------------

constexpr float LOG2E = 1.4426950408889634f;

// a head dim rounded up to wgmma's k-step of 16 columns, and as stored in an
// sw128 tile (sm90.cuh): panels of 64 columns
__host__ __device__ constexpr int pad16(int d) { return (d + 15) / 16 * 16; }
__host__ __device__ constexpr int panels(int d) { return d < 64 ? 64 : (d + 63) / 64 * 64; }
// N of one register-A product over a stored width w: 128 where it divides w
__host__ __device__ constexpr int chunk_n(int w) { return w % 128 == 0 ? 128 : 64; }

// warpgroups that own one 64-row tile, by role (see the header): the dK/dV
// kernel takes two where one cannot hold its keys' dK and dV beside s^T and
// dP^T in registers, the dQ kernel where dQ alone is 128 floats a thread
template <int DQK, int DV>
__host__ __device__ constexpr int kv_roles() { return DQK + DV > 256 ? 2 : 1; }
template <int DQK>
__host__ __device__ constexpr int q_roles() { return DQK > 192 ? 2 : 1; }

// one bf16 instance's shape: tiles of 64 rows, shared memory (bytes)
template <int DQK, int DV>
struct WgBwd {
  static constexpr int QKS = panels(DQK), VS = panels(DV);
  static constexpr int KV_ROLES = kv_roles<DQK, DV>(), Q_ROLES = q_roles<DQK>();
  static constexpr int QK_BYTES = 64 * QKS * 2;   // a tile of q or k
  static constexpr int V_BYTES = 64 * VS * 2;     // of v or dO
  static constexpr int TILES = QK_BYTES + V_BYTES;
  static constexpr int NST = 2;                   // ring stages of the streamed tiles
  static constexpr int XCH = 64 * 64 * 4;         // one 64 x 64 float32 exchange
  // + 1024: the tiles start at the first 1024-byte boundary (swizzle atom).
  // dK/dV: k, v; the stages of q and dO; each stage's lse and D (64 floats
  // each); the roles' exchange
  static constexpr int KV_SMEM = 1024 + (1 + NST) * TILES + NST * 2 * 64 * 4 +
                                 (KV_ROLES - 1) * XCH;
  // dQ: q, dO; the stages of k and v; the roles' two exchanges
  static constexpr int Q_SMEM = 1024 + (1 + NST) * TILES + (Q_ROLES - 1) * 2 * XCH;
  static_assert(KV_SMEM <= 232448 && Q_SMEM <= 232448,
                "over the shared memory a block may use");
};

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// positions [r0, r0 + 64) of one head (rows ``stride`` elements apart, D
// real columns) -> an sw128 tile of 64 rows, by 16-byte cp.async from NT
// threads; the columns from D to pad16(D), and positions at or past S, are
// zero-filled.  The trip count is a constant: where the NT threads cover
// whole rows (NT a multiple of the row's 16-byte chunks) each thread keeps
// one chunk column and steps down the rows, its addresses computed once
// (the swizzle of a row repeats every 8 rows).
template <int D, int NT>
__device__ __forceinline__ void load_sw(uint32_t dst, const bf16* src, size_t stride,
                                        int r0, int S, int tid) {
  constexpr int CPR = pad16(D) / 8;               // 16-byte chunks a row
  static_assert(64 * CPR % NT == 0, "tile must split over the threads");
  if constexpr (NT % CPR == 0 && NT / CPR % 8 == 0) {
    constexpr int RS = NT / CPR;                  // rows between a thread's chunks
    const int r = tid / CPR, c = tid % CPR;
    const bool col = c < D / 8;
    const bf16* from = src + (size_t)(r0 + r) * stride + 8 * c;
    const uint32_t to = dst + sm90::sw128(r, c, 64);
#pragma unroll
    for (int j = 0; j < 64 / RS; ++j) {
      const bool ok = col && r0 + r + RS * j < S;
      sm90::cp_async16(to + RS * j * 128, ok ? from + (size_t)RS * j * stride : src, ok);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 64 * CPR / NT; ++j) {
      const int i = tid + NT * j;
      const int r = i / CPR, c = i % CPR, s = r0 + r;
      const bool ok = s < S && c < D / 8;
      sm90::cp_async16(dst + sm90::sw128(r, c, 64),
                       src + (ok ? (size_t)s * stride + 8 * c : 0), ok);
    }
  }
}

// d (64 x 64) = A B^T over K16 k-steps of 16 columns: the 64 rows of A and
// of B K-major in the sw128 tiles at a and b
template <int K16>
__device__ __forceinline__ void mma_rows(float (&d)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < K16; ++kk) {
    const uint32_t off = (kk >> 2) * (64 * 128) + (kk & 3) * 32;
    sm90::wgmma_ss_n64(d, sm90::desc_sw128(a + off, 16, 1024),
                       sm90::desc_sw128(b + off, 16, 1024), kk > 0);
  }
}

// d[n] (64 x ON each) += A B: A the bf16 register fragments of 64 rows x 64
// (a[kk]: columns 16 kk .. 16 kk + 15), B the 64 rows of the sw128 tile at
// b read N-major, NC x ON of its columns from panel p0 on
template <int ON, int NC>
__device__ __forceinline__ void mma_cols(float (&d)[NC][ON / 2], const uint32_t (&a)[4][4],
                                         uint32_t b, int p0) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const uint64_t db = sm90::desc_sw128(
          b + (p0 + n * (ON / 64)) * (64 * 128) + kk * 2048, 64 * 128, 1024);
      if constexpr (ON == 128) sm90::wgmma_rs_n128_tb(d[n], a[kk], db, 1);
      else sm90::wgmma_rs_n64_tb(d[n], a[kk], db, 1);
    }
}

template <int NC, int N>
__device__ __forceinline__ void fence_all(float (&d)[NC][N]) {
#pragma unroll
  for (int n = 0; n < NC; ++n) sm90::fence_regs(d[n]);
}

template <int NC, int N>
__device__ __forceinline__ void zero_all(float (&d)[NC][N]) {
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int i = 0; i < N; ++i) d[n][i] = 0.f;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// P and P (1 - tanh^2) of one score: ``s`` the raw product q . k, ``l2``
// the row's lse in log2 units; exp2 with log2(e) folded in, as the
// forward.  CAP: soft-capped (``sc`` = scale / cap, ``cl`` = cap log2 e),
// else ``sc`` = scale log2 e.  The cap and the mask are template
// arguments of the loops that call this, so a step's 32 scores carry no
// branch and their exp chains overlap.
template <bool CAP>
__device__ __forceinline__ void prob2(float s, float l2, bool ok, float sc, float cl,
                                      float* p, float* w) {
  float x, dcap = 1.f;
  if constexpr (CAP) {
    const float t = tanhf(s * sc);
    x = cl * t;
    dcap = 1.f - t * t;
  } else {
    x = s * sc;
  }
  *p = ok ? ex2(x - l2) : 0.f;
  *w = *p * dcap;
}

// rows lo and lo + 8 (positions, ``row`` elements apart) of 64-row
// accumulators d[n] (64 x ON each, columns c0 + n ON ..) times f, columns
// below D and positions below S, as float32 (f32_out) or bf16 (rounded
// once, here)
template <int D, int ON, int NC>
__device__ __forceinline__ void store_rows(void* out, int f32_out, size_t row, int lo,
                                           int S, int c0, int c_lo,
                                           const float (&d)[NC][ON / 2], float f) {
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int j = 0; j < ON / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int col = c0 + n * ON + 8 * j + c_lo, pos = lo + 8 * r;
        if (col >= D || pos >= S) continue;
        const float x = d[n][4 * j + 2 * r] * f, y = d[n][4 * j + 2 * r + 1] * f;
        if (f32_out) store2(static_cast<float*>(out) + pos * row + col, x, y);
        else store2(static_cast<bf16*>(out) + pos * row + col, x, y);
      }
}

// D[b, h, s] = sum_c dO[b, s, h, c] O[b, s, h, c] in float32: DV / 8
// threads a (b, s, h) row, 16 bytes of each a thread (o and dout 16-byte
// aligned; DV / 8 is a power of two at every pair built)
template <int DV>
__global__ void flash_bwd_dot_bf16_kernel(const bf16* __restrict__ o,
                                          const bf16* __restrict__ dout,
                                          float* __restrict__ delta, int rows, int S,
                                          int H) {
  constexpr int TPR = DV / 8;
  static_assert((TPR & (TPR - 1)) == 0 && TPR <= 32, "threads a row");
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = t / TPR, c = t % TPR * 8;
  float acc = 0.f;
  if (row < rows) {
    const uint4 a = *reinterpret_cast<const uint4*>(o + (size_t)row * DV + c);
    const uint4 d = *reinterpret_cast<const uint4*>(dout + (size_t)row * DV + c);
    const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* pd = reinterpret_cast<const __nv_bfloat162*>(&d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(pa[i]), y = __bfloat1622float2(pd[i]);
      acc = fmaf(x.x, y.x, fmaf(x.y, y.y, acc));
    }
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && t % TPR == 0) {
    const int h = row % H, s = (row / H) % S, b = row / (H * S);
    delta[((size_t)b * H + h) * S + s] = acc;
  }
}

// what one dK/dV work item's warpgroups share
struct KvItem {
  const bf16* q;
  const bf16* dout;
  const float* lse;
  const float* delta;
  void* pk;                 // dK: [parts, B, S, KV, DQK] float32, or dk
  void* pv;                 // dV: [parts, B, S, KV, DV] float32, or dv
  float* ls;                // [NST][2][64]: each stage's lse, D
  float* xch;               // roles: [32][128] P (1 - tanh^2)
  uint32_t sK, sV, sSt;     // shared addresses: k, v, stage 0 (q, then dO)
  int f32_out, B, S, H, KV, causal, window;
  int b, h0, kvh, part, k0, qt0, nq, n_steps, tid;
  float logit_cap, scale;
};

// P^T (rounded to bf16, into the A fragments pa) and P (1 - tanh^2) (in
// place of s^T) of one step's 64 keys x 64 queries; lse L of the step's
// queries in shared memory
template <bool CAP, bool FULL>
__device__ __forceinline__ void kv_probs(float (&s)[32], uint32_t (&pa)[4][4],
                                         const float* L, int q0, int key_lo, int c_lo,
                                         const KvItem& x) {
  const float sc = CAP ? x.scale / x.logit_cap : x.scale * LOG2E;
  const float cl = x.logit_cap * LOG2E;
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int c = 8 * (i >> 2) + c_lo;         // the step's query columns c, c + 1
    const int key = key_lo + 8 * ((i >> 1) & 1);
    float p[2];
#pragma unroll
    for (int e = 0; e < 2; ++e)
      prob2<CAP>(s[i + e], L[c + e] * LOG2E,
                 FULL || live(q0 + c + e, key, x.S, x.causal, x.window), sc, cl, &p[e],
                 &s[i + e]);
    pa[i >> 3][(i >> 1) & 3] = sm90::pack_bf16(p[0], p[1]);
  }
}

// step ``step`` of an item (query head h0 + step / nq, query tile qt0 +
// step % nq): q, dO, lse and D into stage ``stage``
template <int DQK, int DV, int NT>
__device__ __forceinline__ void kv_load(const KvItem& x, int step, int stage) {
  using C = WgBwd<DQK, DV>;
  const int h = x.h0 + step / x.nq, q0 = (x.qt0 + step % x.nq) * BQ;
  const uint32_t st = x.sSt + stage * C::TILES;
  const size_t head = (size_t)x.b * x.S * x.H + h;
  load_sw<DQK, NT>(st, x.q + head * DQK, (size_t)x.H * DQK, q0, x.S, x.tid);
  load_sw<DV, NT>(st + C::QK_BYTES, x.dout + head * DV, (size_t)x.H * DV, q0, x.S,
                  x.tid);
  if (x.tid < 2 * BQ) {
    const int s = q0 + (x.tid & (BQ - 1));
    const bool ok = s < x.S;
    const float* src = (x.tid < BQ ? x.lse : x.delta) + ((size_t)x.b * x.H + h) * x.S;
    sm90::cp_async4(sm90::smem_addr(x.ls + stage * 2 * BQ + x.tid), src + (ok ? s : 0),
                    ok);
  }
}

// the walk of one warpgroup over an item's steps.  WHAT = 3: the whole
// item (one warpgroup); 1: s^T, P^T, dV (role 0, hands P (1 - tanh^2) over);
// 2: dP^T, dS^T, dK (role 1).  Stores what it keeps.
template <int DQK, int DV, int WHAT>
__device__ __forceinline__ void kv_walk(const KvItem& x) {
  using C = WgBwd<DQK, DV>;
  constexpr bool KEEP_V = WHAT & 1, KEEP_K = WHAT & 2;
  constexpr int NT = 128 * C::KV_ROLES;
  constexpr int OK = chunk_n(C::QKS), NOK = C::QKS / OK;
  constexpr int OV = chunk_n(C::VS), NOV = C::VS / OV;
  const int wt = x.tid & 127, lane = wt & 31;
  const int key_lo = x.k0 + 16 * (wt >> 5) + (lane >> 2);
  const int c_lo = 2 * (lane & 3);
  float dv[KEEP_V ? NOV : 1][OV / 2], dk[KEEP_K ? NOK : 1][OK / 2];
  zero_all(dv);
  zero_all(dk);
  // P^T and dS^T as bf16 A fragments (k-step kk: elements 8 kk .. 8 kk + 7);
  // rewritten only after the wait that retires the products reading them
  uint32_t pa[4][4], sa[4][4];

  for (int step = 0; step < x.n_steps; ++step) {
    const int stage = step & 1;
    sm90::cp_async_wait<0>();   // this step's tiles (and k, v) landed
    sm90::fence_async_shared();
    bar_sync(1, NT);            // ... for every thread
    const uint32_t sQ = x.sSt + stage * C::TILES, sO = sQ + C::QK_BYTES;
    const float* L = x.ls + stage * 2 * BQ;
    const float* Dl = L + BQ;
    const int q0 = (x.qt0 + step % x.nq) * BQ;
    // every (query, key) pair of the step live: no mask to evaluate
    const bool full = q0 + BQ <= x.S && x.k0 + BK <= x.S &&
                      (!x.causal || x.k0 + BK - 1 <= q0) &&
                      (x.window <= 0 || x.k0 > q0 + BQ - 1 - x.window);

    // s^T = k q^T and dP^T = v dO^T: rows keys, columns the step's queries
    float sacc[32], dpacc[32];
    if constexpr (KEEP_V) sm90::fence_regs(sacc);
    if constexpr (KEEP_K) sm90::fence_regs(dpacc);
    sm90::wgmma_fence();
    if constexpr (KEEP_V) {
      mma_rows<pad16(DQK) / 16>(sacc, x.sK, sQ);
      sm90::wgmma_commit();
    }
    if constexpr (KEEP_K) {
      mma_rows<pad16(DV) / 16>(dpacc, x.sV, sO);
      sm90::wgmma_commit();
    }
    // s^T retired (one warpgroup: dP^T may still run), and with it the last
    // step's dV, dK: the other stage is free once every warpgroup is here
    if constexpr (WHAT == 3) sm90::wgmma_wait<1>();
    else sm90::wgmma_wait<0>();
    if constexpr (KEEP_V) sm90::fence_regs(sacc);
    bar_sync(1, NT);
    if (step + 1 < x.n_steps) kv_load<DQK, DV, NT>(x, step + 1, stage ^ 1);
    sm90::cp_async_commit();

    // P^T, and dV += P^T dO (dO read MN-major) while dP^T runs
    if constexpr (KEEP_V) {
      if (x.logit_cap > 0.f) {
        if (full) kv_probs<true, true>(sacc, pa, L, q0, key_lo, c_lo, x);
        else kv_probs<true, false>(sacc, pa, L, q0, key_lo, c_lo, x);
      } else {
        if (full) kv_probs<false, true>(sacc, pa, L, q0, key_lo, c_lo, x);
        else kv_probs<false, false>(sacc, pa, L, q0, key_lo, c_lo, x);
      }
      if constexpr (WHAT == 1) {     // P (1 - tanh^2) to role 1
#pragma unroll
        for (int i = 0; i < 32; ++i) x.xch[i * 128 + wt] = sacc[i];
        bar_arrive(2, NT);
      }
      fence_all(dv);
      sm90::wgmma_fence();
      mma_cols<OV, NOV>(dv, pa, sO, 0);
      sm90::wgmma_commit();
    }
    // dS^T, and dK += dS^T q (q read MN-major)
    if constexpr (KEEP_K) {
      if constexpr (WHAT == 3) sm90::wgmma_wait<1>();  // dP^T retired
      sm90::fence_regs(dpacc);
      if constexpr (WHAT == 2) bar_sync(2, NT);  // role 0's P (1 - tanh^2) is in
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int c = 8 * (i >> 2) + c_lo;
        float w0, w1;
        if constexpr (KEEP_V) {
          w0 = sacc[i];
          w1 = sacc[i + 1];
        } else {
          w0 = x.xch[i * 128 + wt];
          w1 = x.xch[(i + 1) * 128 + wt];
        }
        sa[i >> 3][(i >> 1) & 3] = sm90::pack_bf16(w0 * (dpacc[i] - Dl[c]),
                                                   w1 * (dpacc[i + 1] - Dl[c + 1]));
      }
      fence_all(dk);
      sm90::wgmma_fence();
      mma_cols<OK, NOK>(dk, sa, sQ, 0);
      sm90::wgmma_commit();
    }
  }
  sm90::wgmma_wait<0>();
  if constexpr (KEEP_V) fence_all(dv);
  if constexpr (KEEP_K) fence_all(dk);

  const size_t n_k = (size_t)x.B * x.S * x.KV * DQK, n_v = (size_t)x.B * x.S * x.KV * DV;
  const size_t at = (size_t)x.b * x.S * x.KV + x.kvh;   // position 0 of this KV head
  if constexpr (KEEP_K)
    store_rows<DQK, OK, NOK>(
        x.f32_out ? static_cast<void*>(static_cast<float*>(x.pk) + x.part * n_k + at * DQK)
                  : static_cast<void*>(static_cast<bf16*>(x.pk) + at * DQK),
        x.f32_out, (size_t)x.KV * DQK, key_lo, x.S, 0, c_lo, dk, x.scale);
  if constexpr (KEEP_V)
    store_rows<DV, OV, NOV>(
        x.f32_out ? static_cast<void*>(static_cast<float*>(x.pv) + x.part * n_v + at * DV)
                  : static_cast<void*>(static_cast<bf16*>(x.pv) + at * DV),
        x.f32_out, (size_t)x.KV * DV, key_lo, x.S, 0, c_lo, dv, 1.f);
}

// one block: one work item (b, query heads h0 .. h0 + heads - 1 of one KV
// head, 64-key tile); its query tiles [first, end) of every head, one 64-row
// step each.  Writes scale dS^T q and P^T dO of its keys, summed over its
// heads, to pk, pv at [part, b, s, kvh, :] (part = (h0 % G) / heads) in
// float32 where f32_out, else to dk, dv in bf16.
template <int DQK, int DV>
__global__ void __launch_bounds__(128 * WgBwd<DQK, DV>::KV_ROLES)
flash_bwd_dkdv_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const bf16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            const int* __restrict__ items, void* __restrict__ pk,
                            void* __restrict__ pv, int f32_out, int B, int S, int H,
                            int KV, int heads, int causal, int window,
                            float logit_cap, float scale) {
  using C = WgBwd<DQK, DV>;
  constexpr int NT = 128 * C::KV_ROLES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const int* item = items + (size_t)blockIdx.x * ITEM;
  const int G = H / KV;
  KvItem x;
  x.q = q; x.dout = dout; x.lse = lse; x.delta = delta; x.pk = pk; x.pv = pv;
  x.sK = base;
  x.sV = base + C::QK_BYTES;
  x.sSt = base + C::TILES;
  x.ls = reinterpret_cast<float*>(smem_raw + (base - raw) + (1 + C::NST) * C::TILES);
  x.xch = x.ls + C::NST * 2 * BQ;
  x.f32_out = f32_out; x.B = B; x.S = S; x.H = H; x.KV = KV;
  x.causal = causal; x.window = window; x.logit_cap = logit_cap; x.scale = scale;
  x.b = item[0]; x.h0 = item[1]; x.k0 = item[2] * BK;
  x.qt0 = item[3]; x.nq = item[4] - item[3];
  x.n_steps = heads * x.nq;
  x.kvh = x.h0 / G; x.part = x.h0 % G / heads;
  x.tid = threadIdx.x;

  const size_t kv_at = (size_t)x.b * S * KV + x.kvh;
  load_sw<DQK, NT>(x.sK, k + kv_at * DQK, (size_t)KV * DQK, x.k0, S, x.tid);
  load_sw<DV, NT>(x.sV, v + kv_at * DV, (size_t)KV * DV, x.k0, S, x.tid);
  if (x.n_steps > 0) kv_load<DQK, DV, NT>(x, 0, 0);
  sm90::cp_async_commit();
  if constexpr (C::KV_ROLES == 1) kv_walk<DQK, DV, 3>(x);
  else if (x.tid < 128) kv_walk<DQK, DV, 1>(x);
  else kv_walk<DQK, DV, 2>(x);
  sm90::cp_async_wait<0>();
}

// what one dQ block's warpgroups share
struct QTile {
  const bf16* k;
  const bf16* v;
  const float* lse;
  const float* delta;
  bf16* dq;
  float* xch;               // roles: [2][32][128] P (1 - tanh^2), dP
  uint32_t sQ, sO, sSt;     // shared addresses: q, dO, stage 0 (k, then v)
  int S, H, KV, causal, window, b, h, kvh, q0, key_begin, n_steps, tid;
  float logit_cap, scale;
};

// P (1 - tanh^2) in place of s of one step's 64 queries x 64 keys; l2 the
// rows' lse in log2 units
template <bool CAP, bool FULL>
__device__ __forceinline__ void q_probs(float (&s)[32], const float (&l2)[2], int k0,
                                        int row_lo, int c_lo, const QTile& x) {
  const float sc = CAP ? x.scale / x.logit_cap : x.scale * LOG2E;
  const float cl = x.logit_cap * LOG2E;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    const int kp = k0 + 8 * (i >> 2) + c_lo + (i & 1);
    float p;
    prob2<CAP>(s[i], l2[r], FULL || live(row_lo + 8 * r, kp, x.S, x.causal, x.window),
               sc, cl, &p, &s[i]);
  }
}

// keys [k0, k0 + 64) -> stage ``stage``
template <int DQK, int DV, int NT>
__device__ __forceinline__ void q_load(const QTile& x, int k0, int stage) {
  using C = WgBwd<DQK, DV>;
  const uint32_t st = x.sSt + stage * C::TILES;
  const size_t at = (size_t)x.b * x.S * x.KV + x.kvh;
  load_sw<DQK, NT>(st, x.k + at * DQK, (size_t)x.KV * DQK, k0, x.S, x.tid);
  load_sw<DV, NT>(st + C::QK_BYTES, x.v + at * DV, (size_t)x.KV * DV, k0, x.S, x.tid);
}

// the walk of one warpgroup over the block's key tiles.  WHAT = 3: the whole
// tile (one warpgroup); 1: s, P (1 - tanh^2) and the first half of dQ's
// columns (role 0); 2: dP and the second half (role 1).  Stores its dQ.
template <int DQK, int DV, int WHAT>
__device__ __forceinline__ void q_walk(const QTile& x) {
  using C = WgBwd<DQK, DV>;
  constexpr bool DO_S = WHAT & 1, DO_DP = WHAT & 2;
  constexpr int ROLES = C::Q_ROLES, NT = 128 * ROLES;
  constexpr int W = C::QKS / ROLES, OQ = chunk_n(W), NOQ = W / OQ;
  const int role = WHAT == 2;
  const int wt = x.tid & 127, lane = wt & 31;
  const int row_lo = x.q0 + 16 * (wt >> 5) + (lane >> 2), row_hi = row_lo + 8;
  const int c_lo = 2 * (lane & 3);
  const float* lb = x.lse + ((size_t)x.b * x.H + x.h) * x.S;
  const float* db = x.delta + ((size_t)x.b * x.H + x.h) * x.S;
  const float l2[2] = {row_lo < x.S ? lb[row_lo] * LOG2E : 0.f,
                       row_hi < x.S ? lb[row_hi] * LOG2E : 0.f};
  const float dd[2] = {row_lo < x.S ? db[row_lo] : 0.f, row_hi < x.S ? db[row_hi] : 0.f};
  float dq[NOQ][OQ / 2];
  zero_all(dq);
  uint32_t sa[4][4];   // dS as bf16 A fragments, rewritten after dQ's retires

  for (int step = 0; step < x.n_steps; ++step) {
    const int stage = step & 1;
    sm90::cp_async_wait<0>();   // this step's tiles (and q, dO) landed
    sm90::fence_async_shared();
    bar_sync(1, NT);            // ... for every thread
    const uint32_t sK = x.sSt + stage * C::TILES, sV = sK + C::QK_BYTES;
    const int k0 = x.key_begin + step * BK;
    const bool full = x.q0 + BQ <= x.S && k0 + BK <= x.S &&
                      (!x.causal || k0 + BK - 1 <= x.q0) &&
                      (x.window <= 0 || k0 > x.q0 + BQ - 1 - x.window);

    // s = q k^T and dP = dO v^T: rows the block's queries, columns the step's keys
    float sacc[32], dpacc[32];
    if constexpr (DO_S) sm90::fence_regs(sacc);
    if constexpr (DO_DP) sm90::fence_regs(dpacc);
    sm90::wgmma_fence();
    if constexpr (DO_S) {
      mma_rows<pad16(DQK) / 16>(sacc, x.sQ, sK);
      sm90::wgmma_commit();
    }
    if constexpr (DO_DP) {
      mma_rows<pad16(DV) / 16>(dpacc, x.sO, sV);
      sm90::wgmma_commit();
    }
    // s retired (one warpgroup: dP may still run), and with it the last
    // step's dQ: the other stage is free once every warpgroup is here
    if constexpr (WHAT == 3) sm90::wgmma_wait<1>();
    else sm90::wgmma_wait<0>();
    if constexpr (DO_S) sm90::fence_regs(sacc);
    if constexpr (WHAT == 2) sm90::fence_regs(dpacc);
    bar_sync(1, NT);
    if (step + 1 < x.n_steps)
      q_load<DQK, DV, NT>(x, x.key_begin + (step + 1) * BK, stage ^ 1);
    sm90::cp_async_commit();

    // P (1 - tanh^2) in place of s; the roles trade it for dP
    if constexpr (DO_S) {
      if (x.logit_cap > 0.f) {
        if (full) q_probs<true, true>(sacc, l2, k0, row_lo, c_lo, x);
        else q_probs<true, false>(sacc, l2, k0, row_lo, c_lo, x);
      } else {
        if (full) q_probs<false, true>(sacc, l2, k0, row_lo, c_lo, x);
        else q_probs<false, false>(sacc, l2, k0, row_lo, c_lo, x);
      }
    }
    if constexpr (ROLES == 2) {
      float* mine = x.xch + role * 32 * 128;
      const float* other = x.xch + (1 - role) * 32 * 128;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if constexpr (DO_S) mine[i * 128 + wt] = sacc[i];
        else mine[i * 128 + wt] = dpacc[i];
      }
      bar_sync(2, NT);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if constexpr (DO_S) dpacc[i] = other[i * 128 + wt];
        else sacc[i] = other[i * 128 + wt];
      }
    }
    if constexpr (WHAT == 3) {
      sm90::wgmma_wait<0>();    // dP retired
      sm90::fence_regs(dpacc);
    }
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const float d = dd[(i >> 1) & 1];
      sa[i >> 3][(i >> 1) & 3] = sm90::pack_bf16(sacc[i] * (dpacc[i] - d),
                                                 sacc[i + 1] * (dpacc[i + 1] - d));
    }

    // dQ += dS k over this warpgroup's columns: k read MN-major
    fence_all(dq);
    sm90::wgmma_fence();
    mma_cols<OQ, NOQ>(dq, sa, sK, role * (W / 64));
    sm90::wgmma_commit();
  }
  sm90::wgmma_wait<0>();
  fence_all(dq);
  store_rows<DQK, OQ, NOQ>(x.dq + ((size_t)x.b * x.S * x.H + x.h) * DQK, 0,
                           (size_t)x.H * DQK, row_lo, x.S, role * W, c_lo, dq, x.scale);
}

// one block: 64 query rows of one (batch, head), the last tile first under
// a causal mask (it walks the most key tiles)
template <int DQK, int DV>
__global__ void __launch_bounds__(128 * WgBwd<DQK, DV>::Q_ROLES)
flash_bwd_dq_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, bf16* __restrict__ dq,
                          int S, int H, int KV, int causal, int window,
                          float logit_cap, float scale) {
  using C = WgBwd<DQK, DV>;
  constexpr int NT = 128 * C::Q_ROLES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const int n_tiles = (S + BQ - 1) / BQ;
  QTile x;
  x.k = k; x.v = v; x.dq = dq; x.lse = lse; x.delta = delta;
  x.sQ = base;
  x.sO = base + C::QK_BYTES;
  x.sSt = base + C::TILES;
  x.xch = reinterpret_cast<float*>(smem_raw + (base - raw) + (1 + C::NST) * C::TILES);
  x.S = S; x.H = H; x.KV = KV; x.causal = causal; x.window = window;
  x.logit_cap = logit_cap; x.scale = scale;
  x.b = blockIdx.x / H; x.h = blockIdx.x % H; x.kvh = x.h / (H / KV);
  x.q0 = (causal ? n_tiles - 1 - (int)blockIdx.y : (int)blockIdx.y) * BQ;
  x.tid = threadIdx.x;
  // the forward's live key tiles
  const int kt_end = causal ? min(n_tiles, (x.q0 + BQ - 1) / BK + 1) : n_tiles;
  int kt_begin = 0;
  if (window > 0) {
    const int lo = x.q0 - window - BK + 1;  // live iff kt * BK > lo
    kt_begin = lo < 0 ? 0 : lo / BK + 1;
  }
  x.key_begin = kt_begin * BK;
  x.n_steps = kt_end - kt_begin;

  const size_t at = (size_t)x.b * S * H + x.h;
  load_sw<DQK, NT>(x.sQ, q + at * DQK, (size_t)H * DQK, x.q0, S, x.tid);
  load_sw<DV, NT>(x.sO, dout + at * DV, (size_t)H * DV, x.q0, S, x.tid);
  if (x.n_steps > 0) q_load<DQK, DV, NT>(x, x.key_begin, 0);
  sm90::cp_async_commit();
  if constexpr (C::Q_ROLES == 1) q_walk<DQK, DV, 3>(x);
  else if (x.tid < 128) q_walk<DQK, DV, 1>(x);
  else q_walk<DQK, DV, 2>(x);
  sm90::cp_async_wait<0>();
}

template <int DQK, int DV>
cudaError_t launch_bwd_bf16(const void* q_, const void* k_, const void* v_,
                            const void* o_, const float* lse, const void* dout_,
                            float* delta, void* dq_, void* dk_, void* dv_,
                            const int* items, float* scratch, int B, int S, int H,
                            int KV, int n_items, int heads, int causal, int window,
                            float logit_cap, float scale, cudaStream_t stream) {
  using C = WgBwd<DQK, DV>;
  const bf16* q = static_cast<const bf16*>(q_);
  const bf16* k = static_cast<const bf16*>(k_);
  const bf16* v = static_cast<const bf16*>(v_);
  const bf16* o = static_cast<const bf16*>(o_);
  const bf16* dout = static_cast<const bf16*>(dout_);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_wgmma_kernel<DQK, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         C::KV_SMEM);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<DQK, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, C::Q_SMEM);
  if (err != cudaSuccess) return err;

  const int rows = B * S * H;
  const unsigned dot_blocks = (unsigned)(((size_t)rows * (DV / 8) + 255) / 256);
  flash_bwd_dot_bf16_kernel<DV><<<dot_blocks, 256, 0, stream>>>(o, dout, delta, rows, S, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int parts = H / KV / heads;
  const size_t nk = (size_t)B * S * KV * DQK, nv = (size_t)B * S * KV * DV;
  // the groups' partials go to the float32 scratch; one group writes dk, dv
  void* pk = parts > 1 ? static_cast<void*>(scratch) : dk_;
  void* pv = parts > 1 ? static_cast<void*>(scratch + parts * nk) : dv_;
  flash_bwd_dkdv_wgmma_kernel<DQK, DV>
      <<<n_items, 128 * C::KV_ROLES, C::KV_SMEM, stream>>>(
          q, k, v, dout, lse, delta, items, pk, pv, parts > 1, B, S, H, KV, heads,
          causal, window, logit_cap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (parts > 1) {
    const size_t n4 = (nk > nv ? nk : nv) / 4;
    flash_bwd_sum_kernel<bf16><<<(unsigned)((n4 + 255) / 256), 256, 0, stream>>>(
        reinterpret_cast<const float4*>(scratch),
        reinterpret_cast<const float4*>(scratch + parts * nk), static_cast<bf16*>(dk_),
        static_cast<bf16*>(dv_), nk / 4, nv / 4, parts);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid_q(B * H, (S + BQ - 1) / BQ);
  flash_bwd_dq_wgmma_kernel<DQK, DV><<<grid_q, 128 * C::Q_ROLES, C::Q_SMEM, stream>>>(
      q, k, v, dout, lse, delta, static_cast<bf16*>(dq_), S, H, KV, causal, window,
      logit_cap, scale);
  return cudaGetLastError();
}

template <typename T, int DQK, int DV>
cudaError_t launch_bwd(const void* q_, const void* k_, const void* v_,
                       const void* o_, const float* lse, const void* dout_,
                       float* delta, void* dq_, void* dk_, void* dv_,
                       const int* items, float* scratch, int B, int S, int H,
                       int KV, int n_items, int causal, int window,
                       float logit_cap, float scale, cudaStream_t stream) {
  using C = Bwd<T, DQK, DV>;
  const T* q = static_cast<const T*>(q_);
  const T* k = static_cast<const T*>(k_);
  const T* v = static_cast<const T*>(v_);
  const T* o = static_cast<const T*>(o_);
  const T* dout = static_cast<const T*>(dout_);
  T* dq = static_cast<T*>(dq_);
  T* dk = static_cast<T*>(dk_);
  T* dv = static_cast<T*>(dv_);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::KV_SMEM);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, DQK, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::Q_SMEM);
  if (err != cudaSuccess) return err;

  const int rows = B * S * H;
  flash_bwd_dot_kernel<T><<<(rows + 7) / 8, 256, 0, stream>>>(o, dout, delta, rows,
                                                             S, H, DV);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int G = H / KV;
  const size_t nk = (size_t)B * S * KV * DQK, nv = (size_t)B * S * KV * DV;
  // the G partials go to the float32 scratch; at G = 1 straight to dk, dv
  void* pk = G > 1 ? static_cast<void*>(scratch) : dk_;
  void* pv = G > 1 ? static_cast<void*>(scratch + G * nk) : dv_;
  const int f32_out = G > 1 || sizeof(T) == sizeof(float);
  flash_bwd_dkdv_kernel<T, DQK, DV><<<n_items, C::NT, C::KV_SMEM, stream>>>(
      q, k, v, dout, lse, delta, items, pk, pv, f32_out, B, S, H, KV, causal,
      window, logit_cap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (G > 1) {
    const size_t n4 = (nk > nv ? nk : nv) / 4;
    flash_bwd_sum_kernel<T><<<(unsigned)((n4 + 255) / 256), 256, 0, stream>>>(
        reinterpret_cast<const float4*>(scratch),
        reinterpret_cast<const float4*>(scratch + G * nk), dk, dv, nk / 4, nv / 4, G);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid_q(B * H, (S + BQ - 1) / BQ);
  flash_bwd_dq_kernel<T, DQK, DV><<<grid_q, C::NT, C::Q_SMEM, stream>>>(
      q, k, v, dout, lse, delta, dq, S, H, KV, causal, window, logit_cap, scale);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launches (0 on success).  is_bf16 selects
// the storage type of q, k, v, o, dout and dq, dk, dv: 1 bfloat16, 0
// float32; lse, the scratch delta and the partials are float32 either way.
// Pointers are contiguous (q, k, v and dout 16-byte aligned): q, dq
// [B, S, H, HD]; o, dout [B, S, H, HD_V]; k, dk [B, S, KV, HD]; v, dv
// [B, S, KV, HD_V]; lse and delta [B, H, S].  items is the int32 work table
// [n_items, 5] of the dK/dV kernel (b, first query head, key tile, first and
// end query tile; one row per (b, group of ``heads`` query heads of one KV
// head, key tile)); heads is 1 for float32 and divides G = H / KV.  scratch
// holds the G / heads groups' partials of dK [G / heads, B, S, KV, HD] and
// then of dV [G / heads, B, S, KV, HD_V] (unused, and may be null, with one
// group).  (HD, HD_V) is (8, 8), (16, 16), (32, 32), (64, 64), (128, 128),
// (256, 256), (192, 128) or (24, 16) (the wrapper's _HEAD_DIMS and
// _QK_V_PAIRS), in either type.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const void* lse,
                                   const void* dout, void* delta, void* dq,
                                   void* dk, void* dv, const void* items,
                                   void* scratch, int is_bf16, int B, int S,
                                   int H, int KV, int HD, int HD_V, int causal,
                                   int window, int n_items, int heads,
                                   float logit_cap, float scale, void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || n_items <= 0 || !items ||
      heads <= 0 || (H / KV) % heads != 0 || (!is_bf16 && heads != 1) ||
      (H / KV / heads > 1 && !scratch))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH_BWD(hd_qk, hd_v)                                          \
  if (HD == hd_qk && HD_V == hd_v) {                                          \
    if (is_bf16)                                                              \
      return launch_bwd_bf16<hd_qk, hd_v>(                                    \
          q, k, v, o, static_cast<const float*>(lse), dout,                   \
          static_cast<float*>(delta), dq, dk, dv,                             \
          static_cast<const int*>(items), static_cast<float*>(scratch), B, S, \
          H, KV, n_items, heads, causal, window, logit_cap, scale, st);       \
    return launch_bwd<float, hd_qk, hd_v>(                                    \
        q, k, v, o, static_cast<const float*>(lse), dout,                     \
        static_cast<float*>(delta), dq, dk, dv,                               \
        static_cast<const int*>(items), static_cast<float*>(scratch), B, S,   \
        H, KV, n_items, causal, window, logit_cap, scale, st);                \
  }
  REPRO_FLASH_BWD(8, 8)
  REPRO_FLASH_BWD(16, 16)
  REPRO_FLASH_BWD(32, 32)
  REPRO_FLASH_BWD(64, 64)
  REPRO_FLASH_BWD(128, 128)
  REPRO_FLASH_BWD(256, 256)
  REPRO_FLASH_BWD(192, 128)
  REPRO_FLASH_BWD(24, 16)
#undef REPRO_FLASH_BWD
  return cudaErrorInvalidValue;
}
