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
// gradient dO, all in the model layout (q, o, dO [B, S, H, HD], k, v
// [B, S, KV, HD]), and writes dQ, dK, dV in the layouts of q, k, v.  It
// recomputes the probabilities from lse instead of storing the S x S matrix:
//
//   s  = scale (q . k)                      raw score
//   sc = cap tanh(s / cap)  (or s)          soft-capped score
//   P  = exp(sc - lse) where the mask keeps (causal, window, ragged S), else 0
//   D  = rowsum(dO o O)                     one number a query row
//   dV = P^T dO,   dP = dO V^T,   dS = P (dP - D) (1 - tanh^2(s / cap))
//   dQ = scale dS K,   dK = scale dS^T q
//
// with dK and dV summed over the G = H / KV query heads that read one KV head
// (GQA).
//
// What bounds it: at Llama-3-8B's training shape (B=2, S=512, H=32, KV=8,
// HD=128) the five products of the causal pairs (s, dP, dV, dK, dQ) are
// 10.76 GFLOP of float32-accurate products: 161 us at the 67 TFLOP/s of the
// CUDA cores, or 3 x 10.76 / 495 TFLOP/s = 65 us as 3xTF32 on the tensor
// cores; it moves 84.0 MB (q, k, v, o, dO, lse read once, dq, dk, dv written
// once), 25 us at 3.35 TB/s.  The products bound it.
//
// Why 3xTF32 and not TF32: one TF32 product keeps 10 mantissa bits and misses
// the float32 gradient tolerance (1e-4 of the largest gradient) by 2-4x; the
// split of each operand into big + small TF32 parts (tf32x3.cuh) keeps close
// to float32 accuracy at a third of the TF32 rate, 2.5x the CUDA-core rate.
// Why mma.sync and not wgmma: wgmma takes TF32 operands only K-major from
// shared memory (only 16-bit types may be transposed), and the five products
// read q, k, dO, P and dS in both orientations (s and dP reduce over HD, dV
// and dK over queries, dQ over keys); mma.sync fragments are loaded by each
// thread in either orientation, and the splits are made in registers.
//
// Design.  Four launches:
// - flash_bwd_dot_kernel: D, one warp a row.
// - flash_bwd_dkdv_kernel: one block per work item (b, query head h, 64-key
//   tile), from the wrapper's work table, longest first; it walks the query
//   tiles that can see its keys and keeps dK, dV of its 64 keys in
//   registers.  Items of one KV head's G query heads write partials to the
//   scratch [2, G, B, S, KV, HD] (at G = 1 straight to dk, dv).
// - flash_bwd_sum_kernel (G > 1): dK, dV = the partials summed in the order
//   g = 0 .. G - 1.
// - flash_bwd_dq_kernel: one block per (batch * head, 64-row query tile),
//   the longest rows first under a causal mask; it walks the key tiles its
//   rows can see and keeps dQ in registers.
// Four warps a block, each owning 16 rows (keys, or queries) of the 64 and all
// columns of the step, so P and dS go from the accumulators of s and dP
// straight into the A fragments of the next products (tf32x3.cuh: the
// reduction slots are permuted to match), never through shared memory.
// Tiles are stored with a row stride of HD + 4 floats (4 x an odd number,
// mod 32), so the 32 lanes of every fragment load hit 32 banks, whether it
// reads along rows or down columns.  The streamed tiles (q and dO, or k and
// v) come 32 rows a step by 16-byte cp.async: at HD = 128 in one stage, so a
// block takes 101,632 bytes (dK/dV) or 101,376 (dQ) and two blocks share an
// SM, one's copies overlapping the other's products; below it in two stages,
// the next step's copy overlapping this step's products.  s and dP are
// recomputed by both the dK/dV and the dQ kernels (seven products, not
// five): the price of writing each output once.  Steps whose every pair the
// mask keeps skip the mask.  Every output element is written once after a
// sum in a fixed order (the tensor cores' own within a product, the G
// partials' in the sum kernel): no float atomics, so two runs give the same
// bits.  Tiles the causal or window mask rules out whole are never loaded.

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

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 128;    // four warps, 16 rows each
constexpr int ITEM = 5;         // work-table row: b, h, key tile, first and end query tile

__device__ __forceinline__ bool live(int qp, int kp, int S, int causal, int window) {
  return qp < S && kp < S && (!causal || kp <= qp) &&
         (window <= 0 || kp > qp - window);
}

// P and dS of one score: ``s`` the raw score (scaled q . k), ``l`` and ``d``
// the row's lse and D, ``dp`` = dO . v.
__device__ __forceinline__ void prob_and_ds(float s, float l, float d, float dp,
                                            bool ok, float logit_cap, float* p,
                                            float* ds) {
  float dcap = 1.f;
  if (logit_cap > 0.f) {
    const float t = tanhf(s / logit_cap);
    s = logit_cap * t;
    dcap = 1.f - t * t;
  }
  *p = ok ? expf(s - l) : 0.f;
  *ds = *p * (dp - d) * dcap;
}

// rows row0 .. row0 + ROWS - 1 of an HD-wide row-major array (rows
// ``stride`` floats apart, S of them) -> a tile of row stride HD + 4, by
// 16-byte cp.async; rows past S are zero-filled
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          size_t stride, int row0, int S,
                                          int tid) {
  sm90::cp_async_rows<HD, ROWS, HD + 4, THREADS>(dst, src, stride, row0, S, tid);
}

// The streamed tiles (q and dO in the dK/dV kernel, k and v in the dQ
// kernel) come SR = 32 rows a step.  At HD = 128 one stage keeps a block at
// 101 KB, so two blocks share an SM and one's copies overlap the other's
// products; below it two stages fit twice.  (Both measured faster than
// 64-row steps in two stages, at Llama-3-8B's training shape and at the
// quickstart's hd 64, while this kernel was designed.)
constexpr int SR = 32;
template <int HD>
__host__ __device__ constexpr int n_stages() { return HD >= 128 ? 1 : 2; }

// D[b, h, s] = sum_c dO[b, s, h, c] O[b, s, h, c], one warp a (b, s, h) row
__global__ void flash_bwd_dot_kernel(const float* __restrict__ o,
                                     const float* __restrict__ dout,
                                     float* __restrict__ delta, int rows, int S,
                                     int H, int HD) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* orow = o + (size_t)row * HD;
  const float* drow = dout + (size_t)row * HD;
  float acc = 0.f;
  for (int c = lane; c < HD; c += 32) acc = fmaf(orow[c], drow[c], acc);
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

template <int HD>
constexpr size_t dkdv_smem() {  // k, v; the stages of q, dO, lse, D
  return sizeof(float) * (2 * BK * (HD + 4) + n_stages<HD>() * (2 * SR * (HD + 4) + 2 * SR));
}

template <int HD>
constexpr size_t dq_smem() {    // q, dO; the stages of k, v
  return sizeof(float) * (2 * BQ * (HD + 4) + n_stages<HD>() * 2 * SR * (HD + 4));
}

// one block: one work item (b, query head h, 64-key tile); warp w owns keys
// 16 w .. 16 w + 15 of the tile.  Writes scale dS^T q and P^T dO of its keys
// to pk, pv at [g, b, s, kvh, :] (g = h % G; at G = 1 these are dk, dv).
template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const int* __restrict__ items, float* __restrict__ pk,
                      float* __restrict__ pv, int B, int S, int H, int KV,
                      int causal, int window, float logit_cap, float scale) {
  constexpr int RS = HD + 4;              // row stride of the tiles
  constexpr int NST = n_stages<HD>();
  constexpr int NJ = SR / 8;              // 8-query blocks of the scores
  constexpr int NN = HD / 8;              // 8-column blocks of dK, dV
  constexpr int STAGE = 2 * SR * RS + 2 * SR;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                       // [BK][RS]
  float* Vs = Ks + BK * RS;               // [BK][RS]
  float* stages = Vs + BK * RS;           // NST x {q [SR][RS], dO [SR][RS], lse [SR], D [SR]}

  const int* item = items + (size_t)blockIdx.x * ITEM;
  const int b = item[0], h = item[1], k0 = item[2] * BK;
  const int row_begin = item[3] * BQ, row_end = min(S, item[4] * BQ);
  const int n_steps = (row_end - row_begin + SR - 1) / SR;
  const int G = H / KV, kvh = h / G, g = h % G;
  const int tid = threadIdx.x, lane = tid & 31, r0 = (tid >> 5) * 16;
  const int key_lo = k0 + r0 + (lane >> 2), key_hi = key_lo + 8;
  const int t2 = 2 * (lane & 3);
  const size_t q_row = (size_t)H * HD;    // strides between sequence positions
  const size_t k_row = (size_t)KV * HD;
  const float* qb = q + ((size_t)b * S * H + h) * HD;
  const float* db = dout + ((size_t)b * S * H + h) * HD;
  const float* lb = lse + ((size_t)b * H + h) * S;
  const float* deb = delta + ((size_t)b * H + h) * S;

  auto load_q = [&](int step, float* st) {
    const int q0 = row_begin + step * SR;
    load_tile<HD, SR>(st, qb, q_row, q0, S, tid);
    load_tile<HD, SR>(st + SR * RS, db, q_row, q0, S, tid);
    if (tid < SR) {
      const int s = q0 + tid;
      const bool ok = s < S;
      sm90::cp_async4(sm90::smem_addr(st + 2 * SR * RS + tid), lb + (ok ? s : 0), ok);
      sm90::cp_async4(sm90::smem_addr(st + 2 * SR * RS + SR + tid), deb + (ok ? s : 0), ok);
    }
  };
  load_tile<HD, BK>(Ks, k + ((size_t)b * S * KV + kvh) * HD, k_row, k0, S, tid);
  load_tile<HD, BK>(Vs, v + ((size_t)b * S * KV + kvh) * HD, k_row, k0, S, tid);
  if (NST == 2 && n_steps > 0) load_q(0, stages);
  sm90::cp_async_commit();

  float dk_acc[NN][4], dv_acc[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int step = 0; step < n_steps; ++step) {
    float* Qs = stages + (NST == 2 ? (step & 1) * STAGE : 0);
    float* dOs = Qs + SR * RS;
    const float* Ls = dOs + SR * RS;
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

    // s^T and dP^T: rows keys, columns the step's queries
    float s_acc[NJ][4], dp_acc[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s_acc[j][e] = dp_acc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 8) {
      const auto ka = load_a(Ks, RS, r0, kk, lane);
      const auto va = load_a(Vs, RS, r0, kk, lane);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        mma3(s_acc[j], ka, load_b_t(Qs, RS, 8 * j, kk, lane));
        mma3(dp_acc[j], va, load_b_t(dOs, RS, 8 * j, kk, lane));
      }
    }
    // P^T and dS^T in place
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + t2 + (e & 1);
        float p, ds;
        prob_and_ds(s_acc[j][e] * scale, Ls[c], Ds[c], dp_acc[j][e],
                    full || live(q0 + c, e < 2 ? key_lo : key_hi, S, causal, window),
                    logit_cap, &p, &ds);
        s_acc[j][e] = p;
        dp_acc[j][e] = ds;
      }
    // dV += P^T dO, dK += dS^T q
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const auto pa = acc_as_a(s_acc[j]);
      const auto sa = acc_as_a(dp_acc[j]);
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        mma3(dv_acc[n], pa, load_b_perm(dOs, RS, 8 * j, 8 * n, lane));
        mma3(dk_acc[n], sa, load_b_perm(Qs, RS, 8 * j, 8 * n, lane));
      }
    }
    __syncthreads();  // every warp is done with this stage
  }
  sm90::cp_async_wait<0>();  // an item with no query row still loaded k, v

  const size_t part = (size_t)g * B * S * KV * HD + ((size_t)b * S * KV + kvh) * HD;
#pragma unroll
  for (int n = 0; n < NN; ++n) {
    const int c = 8 * n + t2;
    if (key_lo < S) {
      *reinterpret_cast<float2*>(pk + part + key_lo * k_row + c) =
          make_float2(dk_acc[n][0] * scale, dk_acc[n][1] * scale);
      *reinterpret_cast<float2*>(pv + part + key_lo * k_row + c) =
          make_float2(dv_acc[n][0], dv_acc[n][1]);
    }
    if (key_hi < S) {
      *reinterpret_cast<float2*>(pk + part + key_hi * k_row + c) =
          make_float2(dk_acc[n][2] * scale, dk_acc[n][3] * scale);
      *reinterpret_cast<float2*>(pv + part + key_hi * k_row + c) =
          make_float2(dv_acc[n][2], dv_acc[n][3]);
    }
  }
}

// dk, dv = the G partials [2, G, n4] summed in the order g = 0 .. G - 1
__global__ void flash_bwd_sum_kernel(const float4* __restrict__ part,
                                     float4* __restrict__ dk,
                                     float4* __restrict__ dv, size_t n4, int G) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 a = part[i], c = part[(size_t)G * n4 + i];
  for (int g = 1; g < G; ++g) {
    const float4 x = part[(size_t)g * n4 + i];
    const float4 y = part[(size_t)(G + g) * n4 + i];
    a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
    c.x += y.x; c.y += y.y; c.z += y.z; c.w += y.w;
  }
  dk[i] = a;
  dv[i] = c;
}

// one block: 64 query rows of one (batch, head), the last tile first under a
// causal mask (it walks the most key tiles); warp w owns rows 16 w .. 16 w + 15
template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int S, int H, int KV, int causal, int window,
                    float logit_cap, float scale) {
  constexpr int RS = HD + 4;
  constexpr int NST = n_stages<HD>();
  constexpr int NJ = SR / 8;              // 8-key blocks of the scores
  constexpr int NN = HD / 8;              // 8-column blocks of dQ
  constexpr int STAGE = 2 * SR * RS;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                       // [BQ][RS]
  float* dOs = Qs + BQ * RS;              // [BQ][RS]
  float* stages = dOs + BQ * RS;          // NST x {k [SR][RS], v [SR][RS]}

  const int n_tiles = (S + BQ - 1) / BQ;
  const int b = blockIdx.x / H, h = blockIdx.x % H, kvh = h / (H / KV);
  const int q0 = (causal ? n_tiles - 1 - (int)blockIdx.y : (int)blockIdx.y) * BQ;
  const int tid = threadIdx.x, lane = tid & 31, r0 = (tid >> 5) * 16;
  const int row_lo = q0 + r0 + (lane >> 2), row_hi = row_lo + 8;
  const int t2 = 2 * (lane & 3);
  const size_t q_row = (size_t)H * HD;
  const size_t k_row = (size_t)KV * HD;
  const float* kb = k + ((size_t)b * S * KV + kvh) * HD;
  const float* vb = v + ((size_t)b * S * KV + kvh) * HD;
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
    load_tile<HD, SR>(st, kb, k_row, key_begin + step * SR, S, tid);
    load_tile<HD, SR>(st + SR * RS, vb, k_row, key_begin + step * SR, S, tid);
  };
  load_tile<HD, BQ>(Qs, q + ((size_t)b * S * H + h) * HD, q_row, q0, S, tid);
  load_tile<HD, BQ>(dOs, dout + ((size_t)b * S * H + h) * HD, q_row, q0, S, tid);
  if (NST == 2 && n_steps > 0) load_kv(0, stages);
  sm90::cp_async_commit();

  float dq_acc[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;

  for (int step = 0; step < n_steps; ++step) {
    const float* Ks = stages + (NST == 2 ? (step & 1) * STAGE : 0);
    const float* Vs = Ks + SR * RS;
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

    float s_acc[NJ][4], dp_acc[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s_acc[j][e] = dp_acc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 8) {
      const auto qa = load_a(Qs, RS, r0, kk, lane);
      const auto oa = load_a(dOs, RS, r0, kk, lane);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        mma3(s_acc[j], qa, load_b_t(Ks, RS, 8 * j, kk, lane));
        mma3(dp_acc[j], oa, load_b_t(Vs, RS, 8 * j, kk, lane));
      }
    }
    // dS in place of dP
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + 8 * j + t2 + (e & 1);
        const bool lo = e < 2;
        float p, ds;
        prob_and_ds(s_acc[j][e] * scale, lo ? l_lo : l_hi, lo ? d_lo : d_hi,
                    dp_acc[j][e],
                    full || live(lo ? row_lo : row_hi, kp, S, causal, window),
                    logit_cap, &p, &ds);
        dp_acc[j][e] = ds;
      }
    // dQ += dS k
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const auto sa = acc_as_a(dp_acc[j]);
#pragma unroll
      for (int n = 0; n < NN; ++n)
        mma3(dq_acc[n], sa, load_b_perm(Ks, RS, 8 * j, 8 * n, lane));
    }
    __syncthreads();  // every warp is done with this stage
  }
  sm90::cp_async_wait<0>();

  float* dqb = dq + ((size_t)b * S * H + h) * HD;
#pragma unroll
  for (int n = 0; n < NN; ++n) {
    const int c = 8 * n + t2;
    if (row_lo < S)
      *reinterpret_cast<float2*>(dqb + row_lo * q_row + c) =
          make_float2(dq_acc[n][0] * scale, dq_acc[n][1] * scale);
    if (row_hi < S)
      *reinterpret_cast<float2*>(dqb + row_hi * q_row + c) =
          make_float2(dq_acc[n][2] * scale, dq_acc[n][3] * scale);
  }
}

template <int HD>
cudaError_t launch_bwd(const float* q, const float* k, const float* v,
                       const float* o, const float* lse, const float* dout,
                       float* delta, float* dq, float* dk, float* dv,
                       const int* items, float* scratch, int B, int S, int H,
                       int KV, int n_items, int causal, int window,
                       float logit_cap, float scale, cudaStream_t stream) {
  constexpr size_t smem_kv = dkdv_smem<HD>();
  constexpr size_t smem_q = dq_smem<HD>();
  static_assert(smem_kv <= 232448 && smem_q <= 232448,
                "over the shared memory a block may use");
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_kv);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_q);
  if (err != cudaSuccess) return err;

  const int rows = B * S * H;
  flash_bwd_dot_kernel<<<(rows + 7) / 8, 256, 0, stream>>>(o, dout, delta, rows,
                                                          S, H, HD);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int G = H / KV;
  const size_t n = (size_t)B * S * KV * HD;
  float* pk = G > 1 ? scratch : dk;
  float* pv = G > 1 ? scratch + G * n : dv;
  flash_bwd_dkdv_kernel<HD><<<n_items, THREADS, smem_kv, stream>>>(
      q, k, v, dout, lse, delta, items, pk, pv, B, S, H, KV, causal, window,
      logit_cap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (G > 1) {
    const size_t n4 = n / 4;
    flash_bwd_sum_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, stream>>>(
        reinterpret_cast<const float4*>(scratch), reinterpret_cast<float4*>(dk),
        reinterpret_cast<float4*>(dv), n4, G);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid_q(B * H, (S + BQ - 1) / BQ);
  flash_bwd_dq_kernel<HD><<<grid_q, THREADS, smem_q, stream>>>(
      q, k, v, dout, lse, delta, dq, S, H, KV, causal, window, logit_cap, scale);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launches (0 on success).  All pointers are
// contiguous float32 (q, k, v and dout 16-byte aligned): q, o, dout, dq
// [B, S, H, HD]; k, v, dk, dv [B, S, KV, HD]; lse and the scratch delta
// [B, H, S].  items is the int32 work table [n_items, 5] of the dK/dV kernel
// (b, h, key tile, first and end query tile; one row per (b, h, key tile));
// scratch [2, G, B, S, KV, HD] holds the G = H / KV partials of dK and dV
// (unused, and may be null, at G = 1).  HD is 8, 16, 32, 64 or 128 (the
// wrapper's _BWD_HEAD_DIMS).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const void* lse,
                                   const void* dout, void* delta, void* dq,
                                   void* dk, void* dv, const void* items,
                                   void* scratch, int B, int S, int H, int KV,
                                   int HD, int causal, int window, int n_items,
                                   float logit_cap, float scale, void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || n_items <= 0 || !items ||
      (H / KV > 1 && !scratch))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH_BWD(hd)                                                   \
  if (HD == hd)                                                               \
    return launch_bwd<hd>(                                                    \
        static_cast<const float*>(q), static_cast<const float*>(k),           \
        static_cast<const float*>(v), static_cast<const float*>(o),           \
        static_cast<const float*>(lse), static_cast<const float*>(dout),      \
        static_cast<float*>(delta), static_cast<float*>(dq),                  \
        static_cast<float*>(dk), static_cast<float*>(dv),                     \
        static_cast<const int*>(items), static_cast<float*>(scratch), B, S,   \
        H, KV, n_items, causal, window, logit_cap, scale, st);
  REPRO_FLASH_BWD(8)
  REPRO_FLASH_BWD(16)
  REPRO_FLASH_BWD(32)
  REPRO_FLASH_BWD(64)
  REPRO_FLASH_BWD(128)
#undef REPRO_FLASH_BWD
  return cudaErrorInvalidValue;
}
