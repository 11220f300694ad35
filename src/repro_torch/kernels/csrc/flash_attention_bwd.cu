// Backward of K1 (flash prefill attention) for Hopper (sm_90a), float32.
//
// It replaces no TPU kernel: the reference trains by differentiating its XLA
// attention (src/repro/models/attention.py::chunked_attention, the function
// the Pallas TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// computes, which has no backward); the port's model path runs K1 in every
// attention layer, so the gradient of K1's function needs a kernel of its
// own.  It takes what the float32 forward (flash_attention.cu,
// flash_fwd_f32_mma_kernel) leaves: q, k, v, o and the row log-sum-exp lse
// [B, H, S] of the scaled, soft-capped, masked scores, and the output
// gradient dO, all in the model layout (q [B, S, H, DQK], o, dO
// [B, S, H, DV], k [B, S, KV, DQK], v [B, S, KV, DV]), and writes dQ, dK, dV
// in the layouts of q, k, v.  It recomputes the probabilities from lse
// instead of storing the S x S matrix:
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
// (DQK, DV) = (192, 128) and (24, 16), the pairs the forward builds.
//
// What bounds it: the five products of the causal pairs (s and dK, dQ over
// DQK; dP and dV over DV: 6 DQK + 4 DV operations a pair), at float32
// accuracy, against q, k, v, o, dO and lse read once and dq, dk, dv written
// once:
// - Llama-3-8B's training shape (B=2, S=512, H=32, KV=8, 128): 10.76 GFLOP,
//   161 us at the 67 TFLOP/s of the CUDA cores, or 3 x 10.76 / 495 TFLOP/s =
//   65 us as 3xTF32 on the tensor cores; 84.0 MB, 25 us at 3.35 TB/s.
// - Gemma-2-9B's (B=2, S=512, H=16, KV=8, 256; windows 4,096 and 0 both
//   wider than S): 10.76 GFLOP, 65 us as 3xTF32; 100.7 MB, 30 us.
// - RecurrentGemma-9B's attention (B=2, S=512, H=16, KV=1, 256, window
//   2,048): 10.76 GFLOP, 65 us; 71.3 MB, 21 us.
// - DeepSeek-V2-Lite's MLA (B=2, S=512, H=KV=16, 192 / 128): 6.99 GFLOP,
//   42 us; 84.0 MB, 25 us.
// The products bound it.
//
// Why 3xTF32 and not TF32: one TF32 product keeps 10 mantissa bits and misses
// the float32 gradient tolerance (1e-4 of the largest gradient) by 2-4x; the
// split of each operand into big + small TF32 parts (tf32x3.cuh) keeps close
// to float32 accuracy at a third of the TF32 rate, 2.5x the CUDA-core rate.
// Why mma.sync and not wgmma: wgmma takes TF32 operands only K-major from
// shared memory (only 16-bit types may be transposed), and the five products
// read q, k, dO, P and dS in both orientations (s and dP reduce over the head
// dims, dV and dK over queries, dQ over keys); mma.sync fragments are loaded
// by each thread in either orientation, and the splits are made in registers.
//
// Design.  Four launches:
// - flash_bwd_dot_kernel: D, one warp a row.
// - flash_bwd_dkdv_kernel: one block per work item (b, query head h, 64-key
//   tile), from the wrapper's work table, longest first; it walks the query
//   tiles that can see its keys and keeps dK, dV of its 64 keys in
//   registers.  Items of one KV head's G query heads write partials to the
//   scratch (dK's [G, B, S, KV, DQK], then dV's [G, B, S, KV, DV]; at G = 1
//   straight to dk, dv).
// - flash_bwd_sum_kernel (G > 1): dK, dV = the partials summed in the order
//   g = 0 .. G - 1.
// - flash_bwd_dq_kernel: one block per (batch * head, 64-row query tile),
//   the longest rows first under a causal mask; it walks the key tiles its
//   rows can see and keeps dQ in registers.
// Below hd 256 (SPLIT = 1) a block is four warps, each owning 16 rows
// (keys, or queries) of the 64 and all columns of the step, so P and dS go
// from the accumulators of s and dP straight into the A fragments of the next
// products (tf32x3.cuh: the reduction slots are permuted to match), never
// through shared memory.  At DQK = DV = 256 (SPLIT = 2) one warp cannot hold
// its rows' dK and dV (2 x 128 accumulators a thread, past the 255
// registers), so a block is eight warps and two share 16 rows, by role: in the
// dK/dV kernel warp w < 4 computes s and P and keeps dV (128 registers), warp
// w + 4 computes dP and dS and keeps dK (128); the first hands P (1 - tanh^2)
// to the second through 2 KB of shared memory a pair, laid out as the
// fragments are (each lane reads back the 16 values it would have held), at
// one 64-thread named barrier a step.  Both warps do 2 (DQK + DV) products a
// step, and nothing is computed twice.  In the dQ kernel the pair splits s
// (warp w) from dP (warp w + 4), trades P (1 - tanh^2) and dP the same way,
// and each warp forms dS and keeps half of dQ's columns.  The other way to
// fit, two passes of dK/dV by column halves each recomputing s and dP, does 9
// products a pair where this does 7, with half the warps.  The split is
// chosen by measurement (kernel_ab.py against builds of this file with
// n_split fixed at 1, and at 2 from DQK = 128 up; H100, PERF.md): at hd 256
// one warp holding both spills over 2 KB a thread in the dK/dV kernel and
// runs about 1.4x slower than the pairs; at (192, 128) and at 128 one warp
// runs faster than the pairs, so only hd 256 takes them.
// Tiles are stored with row strides of DQK + 4 and DV + 4 floats (4 x an odd
// number, mod 32: 12, 20, 28, 36, 68, 132, 196, 260), so the 32 lanes of every
// fragment load hit 32 banks, whether it reads along rows or down columns.
// The streamed tiles (q and dO, or k and v) come 32 rows a step by 16-byte
// cp.async: where a head dim reaches 128 in one stage (at DQK = DV = 128 a
// block takes 101,632 bytes (dK/dV) or 101,376 (dQ) and two blocks share an
// SM, one's copies overlapping the other's products; at (192, 128) 126,208
// and 125,952, at 256 208,128 and 216,064, one block an SM), below it in two
// stages, the next step's copy overlapping this step's products.  s and dP
// are recomputed by both the dK/dV and the dQ kernels (seven products, not
// five): the price of writing each output once.  Steps whose every pair the
// mask keeps skip the mask.  Every output element is written once after a sum in a fixed order
// (the tensor cores' own within a product, the G partials' in the sum kernel):
// no float atomics, so two runs give the same bits.  Tiles the causal or window
// mask rules out whole are never loaded.

#include <cuda_runtime.h>

#include "sm90.cuh"
#include "tf32x3.cuh"

namespace {

namespace sm90 = repro_torch::sm90;
using repro_torch::tf32x3::acc_as_a;
using repro_torch::tf32x3::load_a;
using repro_torch::tf32x3::load_b_perm;
using repro_torch::tf32x3::load_b_t;
using repro_torch::tf32x3::mma3;
using repro_torch::tf32x3::Split;

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // keys per tile
constexpr int ITEM = 5;         // work-table row: b, h, key tile, first and end query tile

// The streamed tiles (q and dO in the dK/dV kernel, k and v in the dQ
// kernel) come SR = 32 rows a step.  Where a head dim reaches 128 one stage
// keeps a block at 101 KB (DQK = DV = 128), so two blocks share an SM and
// one's copies overlap the other's products; below it two stages fit twice.
// (Both measured faster than 64-row steps in two stages, at Llama-3-8B's
// training shape and at the quickstart's hd 64, while this kernel was
// designed.)
constexpr int SR = 32;
constexpr int NJ = SR / 8;      // 8-row blocks of a step's scores
constexpr int XCH = NJ * 4 * 32;  // floats of one warp's 16 x SR scores, as fragments

template <int DQK, int DV>
__host__ __device__ constexpr int n_stages() { return DQK >= 128 || DV >= 128 ? 1 : 2; }

// warps that share 16 rows: 2 (by role) where one warp cannot hold dK and dV
template <int DQK, int DV>
__host__ __device__ constexpr int n_split() { return DQK > 192 ? 2 : 1; }

template <int DQK, int DV>
__host__ __device__ constexpr int n_threads() { return 128 * n_split<DQK, DV>(); }

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
// floats apart, S of them) -> a tile of row stride D + 4, by 16-byte cp.async
// from NT threads; rows past S are zero-filled
template <int D, int ROWS, int NT>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          size_t stride, int row0, int S,
                                          int tid) {
  sm90::cp_async_rows<D, ROWS, D + 4, NT>(dst, src, stride, row0, S, tid);
}

// one 16 x 8 accumulator times f to rows lo and hi (``row`` floats apart) at
// columns c, c + 1; rows past S are not written
__device__ __forceinline__ void store_acc(float* base, size_t row, int lo, int hi,
                                          int S, int c, const float (&a)[4],
                                          float f) {
  if (lo < S)
    *reinterpret_cast<float2*>(base + lo * row + c) = make_float2(a[0] * f, a[1] * f);
  if (hi < S)
    *reinterpret_cast<float2*>(base + hi * row + c) = make_float2(a[2] * f, a[3] * f);
}

// D[b, h, s] = sum_c dO[b, s, h, c] O[b, s, h, c], one warp a (b, s, h) row
__global__ void flash_bwd_dot_kernel(const float* __restrict__ o,
                                     const float* __restrict__ dout,
                                     float* __restrict__ delta, int rows, int S,
                                     int H, int DV) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* orow = o + (size_t)row * DV;
  const float* drow = dout + (size_t)row * DV;
  float acc = 0.f;
  for (int c = lane; c < DV; c += 32) acc = fmaf(orow[c], drow[c], acc);
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

template <int DQK, int DV>
constexpr size_t dkdv_smem() {  // k, v; the stages of q, dO, lse, D; the pairs' exchange
  return sizeof(float) * (BK * (DQK + DV + 8) +
                          n_stages<DQK, DV>() * (SR * (DQK + DV + 8) + 2 * SR) +
                          (n_split<DQK, DV>() - 1) * 4 * XCH);
}

template <int DQK, int DV>
constexpr size_t dq_smem() {    // q, dO; the stages of k, v; the pairs' exchange
  return sizeof(float) * (BQ * (DQK + DV + 8) +
                          n_stages<DQK, DV>() * SR * (DQK + DV + 8) +
                          (n_split<DQK, DV>() - 1) * 8 * XCH);
}

// one block: one work item (b, query head h, 64-key tile); warp w owns keys
// 16 (w % 4) .. 16 (w % 4) + 15 of the tile (at SPLIT = 2 warps w and w + 4,
// dV and dK).  Writes scale dS^T q and P^T dO of its keys to pk, pv at
// [g, b, s, kvh, :] (g = h % G; at G = 1 these are dk, dv).
template <int DQK, int DV>
__global__ void __launch_bounds__(n_threads<DQK, DV>())
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const int* __restrict__ items, float* __restrict__ pk,
                      float* __restrict__ pv, int B, int S, int H, int KV,
                      int causal, int window, float logit_cap, float scale) {
  constexpr int RQ = DQK + 4, RV = DV + 4;  // row strides of the q/k and v/dO tiles
  constexpr int NST = n_stages<DQK, DV>();
  constexpr int SPLIT = n_split<DQK, DV>();
  constexpr int NT = n_threads<DQK, DV>();
  constexpr int NK = DQK / 8, NV = DV / 8;  // 8-column blocks of dK, dV
  constexpr int KMAX = DQK > DV ? DQK : DV;
  // SPLIT = 1: dK in acc, dV in acc_v; SPLIT = 2: this warp's dV (role 0) or dK in acc
  constexpr int NA = SPLIT == 1 ? NK : (NK > NV ? NK : NV);
  constexpr int NB = SPLIT == 1 ? NV : 1;
  constexpr int STAGE = SR * (RQ + RV) + 2 * SR;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                       // [BK][RQ]
  float* Vs = Ks + BK * RQ;               // [BK][RV]
  float* stages = Vs + BK * RV;           // NST x {q [SR][RQ], dO [SR][RV], lse [SR], D [SR]}
  float* xch = stages + NST * STAGE;      // SPLIT = 2: [4][XCH], P (1 - tanh^2) a group

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
  const float* qb = q + ((size_t)b * S * H + h) * DQK;
  const float* db = dout + ((size_t)b * S * H + h) * DV;
  const float* lb = lse + ((size_t)b * H + h) * S;
  const float* deb = delta + ((size_t)b * H + h) * S;

  auto load_q = [&](int step, float* st) {
    const int q0 = row_begin + step * SR;
    load_tile<DQK, SR, NT>(st, qb, q_row, q0, S, tid);
    load_tile<DV, SR, NT>(st + SR * RQ, db, o_row, q0, S, tid);
    if (tid < SR) {
      const int s = q0 + tid;
      const bool ok = s < S;
      float* ld = st + SR * (RQ + RV);
      sm90::cp_async4(sm90::smem_addr(ld + tid), lb + (ok ? s : 0), ok);
      sm90::cp_async4(sm90::smem_addr(ld + SR + tid), deb + (ok ? s : 0), ok);
    }
  };
  load_tile<DQK, BK, NT>(Ks, k + ((size_t)b * S * KV + kvh) * DQK, k_row, k0, S, tid);
  load_tile<DV, BK, NT>(Vs, v + ((size_t)b * S * KV + kvh) * DV, v_row, k0, S, tid);
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
    float* Qs = stages + (NST == 2 ? (step & 1) * STAGE : 0);
    float* dOs = Qs + SR * RQ;
    const float* Ls = dOs + SR * RV;
    const float* Ds = Ls + SR;
    if (NST == 1) {         // every warp finished the last step's products
      load_q(step, stages);
      sm90::cp_async_commit();
      sm90::cp_async_wait<0>();
    } else if (step + 1 < n_steps) {  // the other stage's readers finished last step
      load_q(step + 1, stages + ((step + 1) & 1) * STAGE);
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
      for (int kk = 0; kk < KMAX; kk += 8) {
        Split<4> ka, va;
        if (kk < DQK) ka = load_a(Ks, RQ, r0, kk, lane);
        if (kk < DV) va = load_a(Vs, RV, r0, kk, lane);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if (kk < DQK) mma3(s_acc[j], ka, load_b_t(Qs, RQ, 8 * j, kk, lane));
          if (kk < DV) mma3(dp_acc[j], va, load_b_t(dOs, RV, 8 * j, kk, lane));
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
      for (int j = 0; j < NJ; ++j) {
        const auto pa = acc_as_a(s_acc[j]);
        const auto sa = acc_as_a(dp_acc[j]);
#pragma unroll
        for (int n = 0; n < (NK > NV ? NK : NV); ++n) {
          if (n < NV) mma3(acc_v[n], pa, load_b_perm(dOs, RV, 8 * j, 8 * n, lane));
          if (n < NK) mma3(acc[n], sa, load_b_perm(Qs, RQ, 8 * j, 8 * n, lane));
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
        for (int kk = 0; kk < DQK; kk += 8) {
          const auto ka = load_a(Ks, RQ, r0, kk, lane);
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            mma3(x[j], ka, load_b_t(Qs, RQ, 8 * j, kk, lane));
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
        for (int kk = 0; kk < DV; kk += 8) {
          const auto va = load_a(Vs, RV, r0, kk, lane);
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            mma3(x[j], va, load_b_t(dOs, RV, 8 * j, kk, lane));
        }
      }
      pair_sync(grp);
      if (role == 0) {      // dV += P^T dO
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const auto pa = acc_as_a(x[j]);
#pragma unroll
          for (int n = 0; n < NV; ++n)
            mma3(acc[n], pa, load_b_perm(dOs, RV, 8 * j, 8 * n, lane));
        }
      } else {              // dS^T in place of dP^T; dK += dS^T q
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            x[j][e] = xg[(4 * j + e) * 32 + lane] * (x[j][e] - Ds[8 * j + t2 + (e & 1)]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const auto sa = acc_as_a(x[j]);
#pragma unroll
          for (int n = 0; n < NK; ++n)
            mma3(acc[n], sa, load_b_perm(Qs, RQ, 8 * j, 8 * n, lane));
        }
      }
    }
    __syncthreads();  // every warp is done with this stage and the exchange
  }
  sm90::cp_async_wait<0>();  // an item with no query row still loaded k, v

  float* kout = pk + (size_t)g * B * S * KV * DQK + ((size_t)b * S * KV + kvh) * DQK;
  float* vout = pv + (size_t)g * B * S * KV * DV + ((size_t)b * S * KV + kvh) * DV;
  if constexpr (SPLIT == 1) {
#pragma unroll
    for (int n = 0; n < NK; ++n)
      store_acc(kout, k_row, key_lo, key_hi, S, 8 * n + t2, acc[n], scale);
#pragma unroll
    for (int n = 0; n < NV; ++n)
      store_acc(vout, v_row, key_lo, key_hi, S, 8 * n + t2, acc_v[n], 1.f);
  } else if (role == 1) {
#pragma unroll
    for (int n = 0; n < NK; ++n)
      store_acc(kout, k_row, key_lo, key_hi, S, 8 * n + t2, acc[n], scale);
  } else {
#pragma unroll
    for (int n = 0; n < NV; ++n)
      store_acc(vout, v_row, key_lo, key_hi, S, 8 * n + t2, acc[n], 1.f);
  }
}

// dk, dv = the G partials (pk [G, nk4], pv [G, nv4]) summed in the order
// g = 0 .. G - 1
__global__ void flash_bwd_sum_kernel(const float4* __restrict__ pk,
                                     const float4* __restrict__ pv,
                                     float4* __restrict__ dk,
                                     float4* __restrict__ dv, size_t nk4,
                                     size_t nv4, int G) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < nk4) {
    float4 a = pk[i];
    for (int g = 1; g < G; ++g) {
      const float4 x = pk[(size_t)g * nk4 + i];
      a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
    }
    dk[i] = a;
  }
  if (i < nv4) {
    float4 c = pv[i];
    for (int g = 1; g < G; ++g) {
      const float4 y = pv[(size_t)g * nv4 + i];
      c.x += y.x; c.y += y.y; c.z += y.z; c.w += y.w;
    }
    dv[i] = c;
  }
}

// one block: 64 query rows of one (batch, head), the last tile first under a
// causal mask (it walks the most key tiles); warp w owns rows
// 16 (w % 4) .. 16 (w % 4) + 15 (at SPLIT = 2 warps w and w + 4, each half of
// dQ's columns)
template <int DQK, int DV>
__global__ void __launch_bounds__(n_threads<DQK, DV>())
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int S, int H, int KV, int causal, int window,
                    float logit_cap, float scale) {
  constexpr int RQ = DQK + 4, RV = DV + 4;
  constexpr int NST = n_stages<DQK, DV>();
  constexpr int SPLIT = n_split<DQK, DV>();
  constexpr int NT = n_threads<DQK, DV>();
  constexpr int NQ = DQK / 8 / SPLIT;     // 8-column blocks of dQ a warp
  constexpr int KMAX = DQK > DV ? DQK : DV;
  constexpr int STAGE = SR * (RQ + RV);
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                       // [BQ][RQ]
  float* dOs = Qs + BQ * RQ;              // [BQ][RV]
  float* stages = dOs + BQ * RV;          // NST x {k [SR][RQ], v [SR][RV]}
  float* xch = stages + NST * STAGE;      // SPLIT = 2: [4][2][XCH], P (1 - tanh^2) and dP

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
  const float* kb = k + ((size_t)b * S * KV + kvh) * DQK;
  const float* vb = v + ((size_t)b * S * KV + kvh) * DV;
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
  auto load_kv = [&](int step, float* st) {
    load_tile<DQK, SR, NT>(st, kb, k_row, key_begin + step * SR, S, tid);
    load_tile<DV, SR, NT>(st + SR * RQ, vb, v_row, key_begin + step * SR, S, tid);
  };
  load_tile<DQK, BQ, NT>(Qs, q + ((size_t)b * S * H + h) * DQK, q_row, q0, S, tid);
  load_tile<DV, BQ, NT>(dOs, dout + ((size_t)b * S * H + h) * DV, o_row, q0, S, tid);
  if (NST == 2 && n_steps > 0) load_kv(0, stages);
  sm90::cp_async_commit();

  float dq_acc[NQ][4];
#pragma unroll
  for (int n = 0; n < NQ; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;

  for (int step = 0; step < n_steps; ++step) {
    const float* Ks = stages + (NST == 2 ? (step & 1) * STAGE : 0);
    const float* Vs = Ks + SR * RQ;
    if (NST == 1) {
      load_kv(step, stages);
      sm90::cp_async_commit();
      sm90::cp_async_wait<0>();
    } else if (step + 1 < n_steps) {
      load_kv(step + 1, stages + ((step + 1) & 1) * STAGE);
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
      for (int kk = 0; kk < KMAX; kk += 8) {
        Split<4> qa, oa;
        if (kk < DQK) qa = load_a(Qs, RQ, r0, kk, lane);
        if (kk < DV) oa = load_a(dOs, RV, r0, kk, lane);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if (kk < DQK) mma3(ds[j], qa, load_b_t(Ks, RQ, 8 * j, kk, lane));
          if (kk < DV) mma3(dp_acc[j], oa, load_b_t(Vs, RV, 8 * j, kk, lane));
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
        for (int kk = 0; kk < DQK; kk += 8) {
          const auto qa = load_a(Qs, RQ, r0, kk, lane);
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            mma3(ds[j], qa, load_b_t(Ks, RQ, 8 * j, kk, lane));
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
        for (int kk = 0; kk < DV; kk += 8) {
          const auto oa = load_a(dOs, RV, r0, kk, lane);
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            mma3(ds[j], oa, load_b_t(Vs, RV, 8 * j, kk, lane));
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
    for (int j = 0; j < NJ; ++j) {
      const auto sa = acc_as_a(ds[j]);
#pragma unroll
      for (int n = 0; n < NQ; ++n)
        mma3(dq_acc[n], sa, load_b_perm(Ks, RQ, 8 * j, c_off + 8 * n, lane));
    }
    __syncthreads();  // every warp is done with this stage and the exchange
  }
  sm90::cp_async_wait<0>();

  float* dqb = dq + ((size_t)b * S * H + h) * DQK;
#pragma unroll
  for (int n = 0; n < NQ; ++n)
    store_acc(dqb, q_row, row_lo, row_hi, S, c_off + 8 * n + t2, dq_acc[n], scale);
}

template <int DQK, int DV>
cudaError_t launch_bwd(const float* q, const float* k, const float* v,
                       const float* o, const float* lse, const float* dout,
                       float* delta, float* dq, float* dk, float* dv,
                       const int* items, float* scratch, int B, int S, int H,
                       int KV, int n_items, int causal, int window,
                       float logit_cap, float scale, cudaStream_t stream) {
  constexpr size_t smem_kv = dkdv_smem<DQK, DV>();
  constexpr size_t smem_q = dq_smem<DQK, DV>();
  constexpr int NT = n_threads<DQK, DV>();
  static_assert(smem_kv <= 232448 && smem_q <= 232448,
                "over the shared memory a block may use");
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_kv);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<DQK, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_q);
  if (err != cudaSuccess) return err;

  const int rows = B * S * H;
  flash_bwd_dot_kernel<<<(rows + 7) / 8, 256, 0, stream>>>(o, dout, delta, rows,
                                                          S, H, DV);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int G = H / KV;
  const size_t nk = (size_t)B * S * KV * DQK, nv = (size_t)B * S * KV * DV;
  float* pk = G > 1 ? scratch : dk;
  float* pv = G > 1 ? scratch + G * nk : dv;
  flash_bwd_dkdv_kernel<DQK, DV><<<n_items, NT, smem_kv, stream>>>(
      q, k, v, dout, lse, delta, items, pk, pv, B, S, H, KV, causal, window,
      logit_cap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (G > 1) {
    const size_t n4 = (nk > nv ? nk : nv) / 4;
    flash_bwd_sum_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, stream>>>(
        reinterpret_cast<const float4*>(pk), reinterpret_cast<const float4*>(pv),
        reinterpret_cast<float4*>(dk), reinterpret_cast<float4*>(dv), nk / 4,
        nv / 4, G);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid_q(B * H, (S + BQ - 1) / BQ);
  flash_bwd_dq_kernel<DQK, DV><<<grid_q, NT, smem_q, stream>>>(
      q, k, v, dout, lse, delta, dq, S, H, KV, causal, window, logit_cap, scale);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launches (0 on success).  All pointers are
// contiguous float32 (q, k, v and dout 16-byte aligned): q, dq
// [B, S, H, HD]; o, dout [B, S, H, HD_V]; k, dk [B, S, KV, HD]; v, dv
// [B, S, KV, HD_V]; lse and the scratch delta [B, H, S].  items is the int32
// work table [n_items, 5] of the dK/dV kernel (b, h, key tile, first and end
// query tile; one row per (b, h, key tile)); scratch holds the G = H / KV
// partials of dK [G, B, S, KV, HD] and then of dV [G, B, S, KV, HD_V]
// (unused, and may be null, at G = 1).  (HD, HD_V) is (8, 8), (16, 16),
// (32, 32), (64, 64), (128, 128), (256, 256), (192, 128) or (24, 16) (the
// wrapper's _HEAD_DIMS and _QK_V_PAIRS).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const void* lse,
                                   const void* dout, void* delta, void* dq,
                                   void* dk, void* dv, const void* items,
                                   void* scratch, int B, int S, int H, int KV,
                                   int HD, int HD_V, int causal, int window,
                                   int n_items, float logit_cap, float scale,
                                   void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || n_items <= 0 || !items ||
      (H / KV > 1 && !scratch))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH_BWD(hd_qk, hd_v)                                          \
  if (HD == hd_qk && HD_V == hd_v)                                            \
    return launch_bwd<hd_qk, hd_v>(                                           \
        static_cast<const float*>(q), static_cast<const float*>(k),           \
        static_cast<const float*>(v), static_cast<const float*>(o),           \
        static_cast<const float*>(lse), static_cast<const float*>(dout),      \
        static_cast<float*>(delta), static_cast<float*>(dq),                  \
        static_cast<float*>(dk), static_cast<float*>(dv),                     \
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
