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
// 2.5x the CUDA-core rate.  bf16 (training, as the reference trains): every
// product is mma.sync.m16n8k16 with bf16 operands and float32 accumulators,
// the operands from shared memory by ldmatrix (.trans for the ones read down
// their columns); P and dS are rounded to bf16 only as operands of their
// products, as the forward rounds P (the reference's attention rounds P to
// the value dtype before P V); the soft-cap's (1 - tanh^2), the row max, lse
// and D stay float32, and dq, dk, dv are rounded to bf16 once, when stored.
// Why mma.sync and not wgmma: wgmma takes TF32 operands only K-major from
// shared memory (only 16-bit types may be transposed), and the five products
// read q, k, dO, P and dS in both orientations (s and dP reduce over the head
// dims, dV and dK over queries, dQ over keys); mma.sync fragments are loaded
// by each thread in either orientation, and the float32 splits are made in
// registers.  For bf16, wgmma, TMA and warp specialisation are later work:
// this instance is the float32 kernel's design with bf16 fragments.
//
// Design.  Four launches:
// - flash_bwd_dot_kernel: D in float32, one warp a row.
// - flash_bwd_dkdv_kernel: one block per work item (b, query head h, 64-key
//   tile), from the wrapper's work table, longest first; it walks the query
//   tiles that can see its keys and keeps dK, dV of its 64 keys in
//   registers.  Items of one KV head's G query heads write float32 partials
//   to the scratch (dK's [G, B, S, KV, DQK], then dV's [G, B, S, KV, DV]; at
//   G = 1 straight to dk, dv, in their dtype).
// - flash_bwd_sum_kernel (G > 1): dK, dV = the partials summed in the order
//   g = 0 .. G - 1, then stored (bf16: rounded once).
// - flash_bwd_dq_kernel: one block per (batch * head, 64-row query tile),
//   the longest rows first under a causal mask; it walks the key tiles its
//   rows can see and keeps dQ in registers.
// With SPLIT = 1 a block is four warps, each owning 16 rows (keys, or
// queries) of the 64 and all columns of the step, so P and dS go from the
// accumulators of s and dP straight into the A fragments of the next
// products (tf32x3.cuh: the reduction slots are permuted to match; bf16: two
// 16 x 8 accumulators are one 16 x 16 A fragment), never through shared
// memory.  With SPLIT = 2 a block is eight warps and two share 16 rows, by
// role: in the dK/dV kernel warp w < 4 computes s and P and keeps dV, warp
// w + 4 computes dP and dS and keeps dK; the first hands P (1 - tanh^2) to
// the second through 2 KB of shared memory a pair, laid out as the
// fragments are (each lane reads back the 16 values it would have held), at
// one 64-thread named barrier a step.  Both warps do 2 (DQK + DV) products a
// step, and nothing is computed twice.  In the dQ kernel the pair splits s
// (warp w) from dP (warp w + 4), trades P (1 - tanh^2) and dP the same way,
// and each warp forms dS and keeps half of dQ's columns.  The other way to
// fit, two passes of dK/dV by column halves each recomputing s and dP, does 9
// products a pair where this does 7, with half the warps.  The split is
// chosen by measurement for each type (kernel_ab.py against builds of this
// file with n_split changed; NVIDIA H100 80GB HBM3, 700.00 W, PERF.md): float32
// takes pairs at hd 256 only (one warp holding both spills over 2 KB a
// thread and runs about 1.4x slower; at (192, 128) and 128 one warp is
// faster); bf16 takes them from qk 192 (at hd 256 one warp is 1.24-1.32x
// slower, at (192, 128) the pair is 1% faster and spills nothing, at 128 it
// is 1.08x slower).
// Tiles are row-major in shared memory.  float32 rows are DQK + 4 and DV + 4
// floats (4 x an odd number, mod 32: 12, 20, 28, 36, 68, 132, 196, 260), so
// the 32 lanes of every fragment load hit 32 banks, whether it reads along
// rows or down columns; bf16 rows are the head dim padded to 16 columns
// (zero-filled: DQK = 8 and 24 reduce over 16 and 32) plus 8 elements, an
// odd number of 16-byte units, so the 8 rows an ldmatrix matrix reads hit 8
// bank groups.  The streamed tiles (q and dO, or k and v) come 32 rows a
// step by 16-byte cp.async: in float32 where a head dim reaches 128 in one
// stage (at DQK = DV = 128 a block takes 101,632 bytes (dK/dV) or 101,376
// (dQ) and two blocks share an SM, one's copies overlapping the other's
// products; at (192, 128) 126,208 and 125,952, at 256 208,128 and 216,064,
// one block an SM), below it, and in bf16 at every pair, in two stages, the
// next step's copy overlapping this step's products.  s and dP are
// recomputed by both the dK/dV and the dQ kernels (seven products, not
// five): the price of writing each output once.  Steps whose every pair the
// mask keeps skip the mask.  Every output element is written once after a
// sum in a fixed order (the tensor cores' own within a product, the G
// partials' in the sum kernel): no float atomics, so two runs give the same
// bits.  Tiles the causal or window mask rules out whole are never loaded.

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

// The streamed tiles (q and dO in the dK/dV kernel, k and v in the dQ
// kernel) come SR = 32 rows a step.  In float32, where a head dim reaches 128
// one stage keeps a block at 101 KB (DQK = DV = 128), so two blocks share an
// SM and one's copies overlap the other's products; below it two stages fit
// twice.  (Both measured faster than 64-row steps in two stages, at
// Llama-3-8B's training shape and at the quickstart's hd 64, while the
// float32 kernel was designed.)  bf16 tiles are half the bytes: two stages
// at every pair.
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

// bf16: mma.sync.m16n8k16 with float32 accumulators, K = 16, every operand
// from shared memory by ldmatrix (.trans for load_b), or from the
// accumulators rounded to bf16 (P and dS: the accumulator layout of two
// 16 x 8 products is the A fragment of one over their 16 columns).  Head dims
// are stored padded to 16 columns, the pad zero-filled (exact for the
// products that reduce over it; DQK = 8 and 24); a row is width + 8
// elements, an odd number of 16-byte units, so the 8 rows an ldmatrix
// matrix reads hit 8 different bank groups
template <>
struct Mma<bf16> {
  static constexpr int K = 16;
  static constexpr int PAD = 8;
  struct A { uint32_t r[4]; };
  struct B { uint32_t r[2]; };
  __host__ __device__ static constexpr int width(int d) { return (d + 15) / 16 * 16; }
  __device__ static A load_a(const bf16* t, int ld, int r0, int c0, int lane) {
    A a;
    sm90::ldmatrix_x4(a.r, sm90::smem_addr(t + (r0 + (lane & 15)) * ld + c0 +
                                           (lane >> 4) * 8));
    return a;
  }
  __device__ static B load_b_t(const bf16* t, int ld, int n0, int c0, int lane) {
    B b;
    sm90::ldmatrix_x2(b.r, sm90::smem_addr(t + (n0 + (lane & 7)) * ld + c0 +
                                           ((lane >> 3) & 1) * 8));
    return b;
  }
  __device__ static B load_b(const bf16* t, int ld, int k0, int n0, int lane) {
    B b;
    sm90::ldmatrix_x2_trans(b.r, sm90::smem_addr(t + (k0 + (lane & 15)) * ld + n0));
    return b;
  }
  template <int N>
  __device__ static A acc_as_a(const float (&c)[N][4], int j) {
    return {{sm90::pack_bf16(c[j][0], c[j][1]), sm90::pack_bf16(c[j][2], c[j][3]),
             sm90::pack_bf16(c[j + 1][0], c[j + 1][1]),
             sm90::pack_bf16(c[j + 1][2], c[j + 1][3])}};
  }
  __device__ static void mma(float (&d)[4], const A& a, const B& b) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b.r[0]),
          "r"(b.r[1]));
  }
};

// warps that share 16 rows: 2 (by role) where one warp cannot hold dK and
// dV or the pair measured faster; chosen by measurement for each storage
// type (see the header): float32 at hd 256, bf16 from qk 192
template <typename T, int DQK, int DV>
__host__ __device__ constexpr int n_split() {
  return sizeof(T) == 2 ? (DQK > 128 ? 2 : 1) : (DQK > 192 ? 2 : 1);
}

// one instance's shape: head dims as stored, row strides, warps, stages,
// shared memory (bytes)
template <typename T, int DQK, int DV>
struct Bwd {
  static constexpr int DQP = Mma<T>::width(DQK), DVP = Mma<T>::width(DV);
  static constexpr int RQ = DQP + Mma<T>::PAD, RV = DVP + Mma<T>::PAD;
  static constexpr int KMAX = DQP > DVP ? DQP : DVP;
  static constexpr int SPLIT = n_split<T, DQK, DV>();
  static constexpr int NT = 128 * SPLIT;
  static constexpr int NST = sizeof(T) == 2 || (DQK < 128 && DV < 128) ? 2 : 1;
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
// [n_items, 5] of the dK/dV kernel (b, h, key tile, first and end query
// tile; one row per (b, h, key tile)); scratch holds the G = H / KV
// partials of dK [G, B, S, KV, HD] and then of dV [G, B, S, KV, HD_V]
// (unused, and may be null, at G = 1).  (HD, HD_V) is (8, 8), (16, 16),
// (32, 32), (64, 64), (128, 128), (256, 256), (192, 128) or (24, 16) (the
// wrapper's _HEAD_DIMS and _QK_V_PAIRS), in either type.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const void* lse,
                                   const void* dout, void* delta, void* dq,
                                   void* dk, void* dv, const void* items,
                                   void* scratch, int is_bf16, int B, int S,
                                   int H, int KV, int HD, int HD_V, int causal,
                                   int window, int n_items, float logit_cap,
                                   float scale, void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || n_items <= 0 || !items ||
      (H / KV > 1 && !scratch))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH_BWD(hd_qk, hd_v)                                          \
  if (HD == hd_qk && HD_V == hd_v)                                            \
    return (is_bf16 ? launch_bwd<bf16, hd_qk, hd_v> : launch_bwd<float, hd_qk, hd_v>)( \
        q, k, v, o, static_cast<const float*>(lse), dout,                     \
        static_cast<float*>(delta), dq, dk, dv,                               \
        static_cast<const int*>(items), static_cast<float*>(scratch), B, S,   \
        H, KV, n_items, causal, window, logit_cap, scale, st);
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
