// Flash prefill attention for Hopper (sm_90a): causal / sliding-window /
// soft-capped GQA attention with an online softmax over KV tiles.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (_flash_kernel, called by flash_attention).  The TPU kernel walks the KV
// axis as the sequential minor grid dimension and keeps (m, l, acc) in VMEM
// scratch between grid steps; here blocks run in parallel in no order, so one
// block owns one (batch*head, 64-row query tile) and walks the KV tiles in a
// loop of its own, keeping (m, l, acc) in float32 registers.
//
// Layout: q is contiguous [B, S, H, DQK], k [B, S, KV, DQK], v [B, S, KV, DV]
// and o [B, S, H, DV], the model layout, so the caller transposes nothing.
// DQK, the head dim of q and k, may exceed DV, that of v and o: MLA
// (DeepSeek-V2) attends with q/k of 192 = 128 nope + 64 rope columns against
// v of 128 (reduced: 24 against 16).  The instances are pairs (DQK, DV):
// (8, 16, 32, 64, 80, 128, 256, same) and (192, 128), (24, 16); 80 is
// StableLM's head dim (d 2,560 over 32 heads).  Query head h reads KV
// head h / (H / KV), the Pallas index map's b // g.  The ragged edge of S is
// masked here, not padded by the caller.  KV tiles that the causal or window
// mask rules out for the whole query tile are never loaded.
//
// What bounds it: at Llama-3-8B's prefill shape (S=512, H=32, KV=8, HD=128)
// the causal products are 2.15 GFLOP, 2.2 us at the bf16 tensor-core rate,
// against 10.5 MB of q, k, v and o, 3.1 us at 3.35 TB/s: both are small, so
// what the design must avoid is float32 FMAs (67 TFLOP/s, 32 us) and loads
// that stall the products.  Two instances, both on the tensor cores:
//
// bfloat16 (the model path: serving, and training in bf16),
// flash_fwd_wgmma_kernel: one warpgroup (128
// threads) owns the 64-row query tile, wgmma's M.  S = Q K^T is
// wgmma.m64n64k16 with Q and K read from shared memory (sw128 tiles, see
// sm90.cuh); the scale, soft-cap, mask and online softmax act on the float32
// accumulator fragments in registers (row max and sum over the 4 lanes of a
// quad, exp2 with log2(e) folded into the scale); P is rounded to bf16 in
// registers and is the register A operand of O += P V (wgmma.m64nNk16, V read
// N-major from shared memory), accumulated in float32 -- the numerics of the
// reference model path (src/repro/models/attention.py casts P to the value
// dtype before P V, float32 accumulation).  K/V tiles of 64 keys stream
// through a 2-stage ring of cp.async copies: tile kt+1 is in flight while kt
// is computed.  Q K^T runs over DQK rounded up to wgmma's k-step of 16: the
// columns from DQK to that (DQK = 8 and 24) are zero-filled by the copies,
// which is exact for the product.  Head dims under 64 are stored in a
// 64-column panel, others in whole panels (80: a 64- and a 16-column k-step
// span of a 128-column tile); P V writes the V tile's width (at least 64, a
// legal wgmma N: 128 at DV = 80) and the output columns past DV are dropped.
// The V tile's columns from pad16(DV) on are never written by the copies;
// each output column reads only its own V column, so whatever they hold
// reaches only the dropped columns, never o or lse.  At (192, 128) the shared
// memory is the Q tile (24 KB) and two stages of a K (24 KB) and a V (16 KB)
// tile, 107,520 bytes with the alignment pad; at 256 it is 164,864.  The
// grid's y axis walks query tiles from the last, so the causal tiles with the
// most KV tiles start first.
//
// float32 (float32 training and every float32 check), flash_fwd_f32_mma_kernel:
// what bounds it at Llama-3-8B's training shape (B=2, S=512, H=32, KV=8,
// HD=128, with lse) is 4.30 GFLOP of float32-accurate products, 64 us on the
// float32 CUDA cores and 26 us as 3xTF32 on the tensor cores, against 42.1
// MB moved (12.6 us).  One TF32 product keeps 10 mantissa bits and misses
// the 2e-5 float32 tolerance; the 3xTF32 split of tf32x3.cuh (each operand
// big + small, three mma.sync.m16n8k8 a product) meets it at 2.5x the CUDA
// cores' rate, as in K1's backward.  The design:
//  - each warp owns 16 query rows; a block is 128 rows (8 warps) at
//    hd 128, where the shared memory allows no second block on an SM, and
//    64 rows (4 warps) elsewhere, so small grids fill the card.  S =
//    (scale q) K^T and O += P V are both m16n8k8 TF32 in the 3xTF32 split.
//    At DV = 256 two warps share 16 rows, each owning 128 output columns (S
//    computed twice), so the O accumulator stays at 64 floats a thread.
//  - q is scaled in float32 and split once per block into two planes of
//    TF32 bits in shared memory; Q's and K's fragments come by ldmatrix (4
//    fragments an instruction), K's and V's split as loaded, as the
//    backward does.
//  - K/V tiles of 32 keys stream by 16-byte cp.async copies through a
//    2-stage ring (tile kt + 1 lands while kt is computed, one barrier a
//    tile); at (256, 256), where a ring does not fit, through one K and one
//    V tile (V(kt) lands while S(kt) is computed, K(kt + 1) while P V(kt)
//    is, two barriers a tile).  Row strides follow each tile's reader
//    (F32Cfg).
//  - the scale, soft-cap, mask and online softmax act on the accumulator
//    fragments in registers (row max and sum over the 4 lanes of a quad;
//    exp2 with log2(e) folded in after the product, so q is still scaled in
//    float32 before it, as the Pallas kernel does); P goes from the score
//    accumulators to the A fragments of P V in registers (tf32x3.cuh's
//    permuted reduction slots, V read at rows 2t and 2t + 1); the O rescale
//    is skipped when no row max of the warp moved (a factor of 1).
//  - the grid's y axis walks query tiles from the last, so the causal tiles
//    with the most KV tiles start first; tiles that hold no key of a warp's
//    rows are skipped by that warp.
// Why mma.sync and not wgmma: TF32 wgmma takes B only K-major from shared
// memory, so P V would need V transposed into shared memory, both split
// planes of each operand there (the split cannot be made in registers), and
// a layout for each of the eight (DQK, DV) pairs; the mma.sync fragments,
// loaders and the accumulator-to-A trick of K1's and K4's backwards serve
// every pair.
//
// Both instances, given an lse pointer (training: the backward in
// flash_attention_bwd.cu recomputes the probabilities from it), also write
// each row's log-sum-exp in natural log, m ln 2 + log(l), float32 [B, H, S],
// in their epilogue, where l is summed and m held; serving passes none, and
// o does not depend on it.  Every output is written once after sums in a
// fixed order: no atomics, the same bits from run to run.

#include <stdint.h>

#include "sm90.cuh"
#include "tf32x3.cuh"

namespace {

namespace sm90 = repro_torch::sm90;
using bf16 = __nv_bfloat16;

constexpr int BQ = 64;          // query rows per block
constexpr float NEG_INF = -2.0e38f;  // the Pallas kernel's mask value
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (wgmma)
// ---------------------------------------------------------------------------

// width of a head dim rounded up to wgmma's k-step of 16 columns, and as
// stored: panels of 64 columns
__host__ __device__ constexpr int pad16(int d) { return (d + 15) / 16 * 16; }
__host__ __device__ constexpr int panels(int d) { return d < 64 ? 64 : (d + 63) / 64 * 64; }

template <int DQK, int DV>
struct TcCfg {
  static constexpr int QKS = panels(DQK);          // q/k head dim as stored
  static constexpr int VS = panels(DV);            // v head dim as stored
  static constexpr int BK = 64;                    // keys per tile
  static constexpr int STAGES = 2;                 // K/V ring depth
  static constexpr int ON = VS < 128 ? VS : 128;   // N of one P V wgmma
  static constexpr int NO = VS / ON;               // P V wgmmas per k-step
  static constexpr int Q_BYTES = BQ * QKS * 2;
  static constexpr int K_BYTES = BK * QKS * 2;     // one K tile
  static constexpr int V_BYTES = BK * VS * 2;      // one V tile
  static constexpr int STAGE_BYTES = K_BYTES + V_BYTES;
  // + 1024: the tiles start at the first 1024-byte boundary (swizzle atom)
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * STAGE_BYTES;
  static_assert(SMEM <= 232448, "over the shared memory a block may use");
  static_assert(VS % ON == 0 && ON % 64 == 0, "P V panels");
};

// cp.async of sequence positions [r0, r0 + R) of one head (row stride
// `stride` elements, D real columns) into an sw128 tile of R rows; the
// columns from D to pad16(D), and positions at or past S, are zero-filled.
template <int D, int R>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          size_t stride, int r0, int S,
                                          int tid) {
  constexpr int CPR = pad16(D) / 8;                // 16-byte chunks per row
  static_assert(R * CPR % 128 == 0, "tile must split over 128 threads");
#pragma unroll
  for (int j = 0; j < R * CPR / 128; ++j) {
    const int i = tid + 128 * j;
    const int r = i / CPR, c = i % CPR, s = r0 + r;
    const bool ok = s < S && c < D / 8;
    sm90::cp_async16(dst + sm90::sw128(r, c, R),
                     src + (size_t)(ok ? s : 0) * stride + (ok ? c * 8 : 0), ok);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_qk(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (N == 64) sm90::wgmma_ss_n64(d, da, db, accumulate);
  else sm90::wgmma_ss_n32(d, da, db, accumulate);
}

template <int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 128) sm90::wgmma_rs_n128_tb(d, a, db, 1);
  else sm90::wgmma_rs_n64_tb(d, a, db, 1);
}

template <int DQK, int DV>
__global__ void __launch_bounds__(128, 1)
flash_fwd_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o,
                       float* __restrict__ lse, int S, int H, int KV, int causal,
                       int window, float logit_cap, float scale) {
  using C = TcCfg<DQK, DV>;
  constexpr int BK = C::BK, STAGES = C::STAGES, ON = C::ON, NO = C::NO;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (sm90::smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sKV = sQ + C::Q_BYTES;  // stage s: its K tile, then its V tile

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // last tiles first
  const size_t q_row = (size_t)H * DQK;   // strides between sequence positions
  const size_t k_row = (size_t)KV * DQK;
  const size_t v_row = (size_t)KV * DV;
  const size_t o_row = (size_t)H * DV;
  const bf16* qb = q + ((size_t)b * S * H + h) * DQK;
  const bf16* kb = k + ((size_t)b * S * KV + kvh) * DQK;
  const bf16* vb = v + ((size_t)b * S * KV + kvh) * DV;
  bf16* ob = o + ((size_t)b * S * H + h) * DV;

  // live KV tiles: causal -> k_start <= last query row of the tile;
  // window -> k_start + BK - 1 > q0 - window (the Pallas block-skip rule)
  const int n_tiles = (S + BK - 1) / BK;
  const int kt_end = causal ? min(n_tiles, (q0 + BQ - 1) / BK + 1) : n_tiles;
  int kt_begin = 0;
  if (window > 0) {
    const int lo = q0 - window - BK + 1;  // live iff kt * BK > lo
    kt_begin = lo < 0 ? 0 : lo / BK + 1;
  }
  auto load_kv = [&](int stage, int kt) {
    const uint32_t st = sKV + stage * C::STAGE_BYTES;
    load_tile<DQK, BK>(st, kb, k_row, kt * BK, S, tid);
    load_tile<DV, BK>(st + C::K_BYTES, vb, v_row, kt * BK, S, tid);
  };

  // prologue: Q with the first STAGES - 1 K/V tiles, one commit group each
  load_tile<DQK, BQ>(sQ, qb, q_row, q0, S, tid);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    const int kt = kt_begin + st;
    if (kt < kt_end) load_kv(st, kt);
    sm90::cp_async_commit();
  }

  // accumulator fragments: this thread holds rows r_lo and r_lo + 8 of the
  // tile, columns 8 j + c_lo and 8 j + c_lo + 1 of every 8-column block j;
  // element 4 j + e sits at row r_lo + 8 (e >> 1), column 8 j + c_lo + (e & 1)
  const int r_lo = warp * 16 + (lane >> 2);
  const int c_lo = 2 * (lane & 3);
  float oacc[NO][ON / 2];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < ON / 2; ++i) oacc[n][i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};      // this thread's columns only; summed at the end
  const float scale2 = scale * LOG2E;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int it = kt - kt_begin;
    sm90::cp_async_wait<STAGES - 2>();  // tile kt (and Q) landed
    sm90::fence_async_shared();
    __syncthreads();  // ... for every thread; tile kt-1's readers are done
    {
      const int nk = kt + STAGES - 1;
      const int ns = (it + STAGES - 1) % STAGES;
      if (nk < kt_end) load_kv(ns, nk);
      sm90::cp_async_commit();
    }
    const uint32_t sK = sKV + (it % STAGES) * C::STAGE_BYTES;
    const uint32_t sV = sK + C::K_BYTES;

    // S = Q K^T over the head dim padded to 16 columns (16 a step)
    float sacc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sacc[i] = 0.f;
    sm90::fence_regs(sacc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < pad16(DQK) / 16; ++kk) {
      const uint64_t da = sm90::desc_sw128(
          sQ + (kk >> 2) * (BQ * 128) + (kk & 3) * 32, 16, 1024);
      const uint64_t db = sm90::desc_sw128(
          sK + (kk >> 2) * (BK * 128) + (kk & 3) * 32, 16, 1024);
      wgmma_qk<BK>(sacc, da, db, kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sacc);

    // scale, soft-cap, mask (only on tiles that cross an edge), row max
    const int k0 = kt * BK;
    const bool edge = (causal && k0 + BK - 1 > q0) ||
                      (window > 0 && k0 <= q0 + BQ - 1 - window) ||
                      k0 + BK > S;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      float s;
      if (logit_cap > 0.f)
        s = logit_cap * tanhf(sacc[i] * scale / logit_cap) * LOG2E;
      else
        s = sacc[i] * scale2;
      if (edge) {
        const int qp = q0 + r_lo + 8 * ((i >> 1) & 1);
        const int kp = k0 + 8 * (i >> 2) + c_lo + (i & 1);
        const bool ok = kp < S && (!causal || kp <= qp) &&
                        (window <= 0 || kp > qp - window);
        s = ok ? s : NEG_INF;
      }
      sacc[i] = s;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s);
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
    // P in bf16: the A fragment of k-step kk is elements 8 kk .. 8 kk + 7
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int i = 0; i < BK / 2; i += 2) {
      const int r = (i >> 1) & 1;
      const float p0 = exp2f(sacc[i] - m[r]);
      const float p1 = exp2f(sacc[i + 1] - m[r]);
      l[r] += p0 + p1;
      pa[i >> 3][(i >> 1) & 3] = sm90::pack_bf16(p0, p1);
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int i = 0; i < ON / 2; ++i) oacc[n][i] *= corr[(i >> 1) & 1];

    // O += P V: V N-major, panels of 64 head-dim columns, 16 keys a step
#pragma unroll
    for (int n = 0; n < NO; ++n) sm90::fence_regs(oacc[n]);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const uint64_t db = sm90::desc_sw128(
            sV + n * (ON / 64) * (BK * 128) + kk * 2048, BK * 128, 1024);
        wgmma_pv<ON>(oacc[n], pa[kk], db);
      }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int n = 0; n < NO; ++n) sm90::fence_regs(oacc[n]);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int j = 0; j < ON / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qp = q0 + r_lo + 8 * r;
        const int col = n * ON + 8 * j + c_lo;
        if (qp < S && col < DV) {
          const uint32_t pk = sm90::pack_bf16(oacc[n][4 * j + 2 * r] * inv[r],
                                              oacc[n][4 * j + 2 * r + 1] * inv[r]);
          *reinterpret_cast<uint32_t*>(ob + qp * o_row + col) = pk;
        }
      }
  // natural log, as the backward reads it: m is in log2 units, lse = m ln 2
  // + log l (the float32 instance's epilogue)
  if (lse != nullptr && (lane & 3) == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = q0 + r_lo + 8 * r;
      if (qp < S)
        lse[((size_t)b * H + h) * S + qp] = m[r] * LN2 + logf(fmaxf(l[r], 1e-30f));
    }
}

template <int DQK, int DV>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o,
                         void* lse, int B, int S, int H, int KV, int causal, int window,
                         float logit_cap, float scale, cudaStream_t stream) {
  constexpr int smem = TcCfg<DQK, DV>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<DQK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  flash_fwd_wgmma_kernel<DQK, DV><<<grid, 128, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), S, H, KV, causal, window, logit_cap, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: tensor cores, 3xTF32 (mma.sync.m16n8k8)
// ---------------------------------------------------------------------------

namespace tf32x3 = repro_torch::tf32x3;

// One instance's shape: BQ query rows a block, in warps of 16 rows; at
// DV > 128 two warps share 16 rows, each owning half of the output columns
// (both compute the rows' scores).  K/V tiles of 32 keys.  Shared memory: the
// scaled Q tile as two planes of TF32 bits (small, big), then either a
// 2-stage ring of K and V tiles (STAGES = 2: tile kt + 1 lands while kt is
// computed, one barrier a tile) or one K and one V tile (STAGES = 1: V(kt)
// lands while S(kt) is computed and K(kt + 1) while P V(kt) is, two barriers
// a tile).  Row strides: Q and K are read by ldmatrix along rows (stride
// DQK + 4 floats: an odd number of 16-byte units, so the 8 rows of a matrix
// hit 8 different 16-byte bank groups); V down its columns at rows 2t and
// 2t + 1 (stride DV + 4: 2 (DV + 4) = 8 mod 32, so the 4 row pairs x 8
// columns of a load hit 32 banks).
template <int DQK, int DV, int BQ_, int STAGES_>
struct F32Cfg {
  static constexpr int BQ = BQ_;
  static constexpr int BK = 32;
  static constexpr int STAGES = STAGES_;
  static constexpr int NSPLIT = DV > 128 ? 2 : 1;
  static constexpr int DVW = DV / NSPLIT;          // output columns of a warp
  static constexpr int ROW_WARPS = BQ / 16;
  static constexpr int THREADS = 32 * ROW_WARPS * NSPLIT;
  static constexpr int RSQ = DQK + 4;
  static constexpr int RSV = DV + 4;
  static constexpr int Q_WORDS = BQ * RSQ;         // one Q plane
  static constexpr int K_WORDS = BK * RSQ;
  static constexpr int STAGE_WORDS = K_WORDS + BK * RSV;
  static constexpr int SMEM = 4 * (2 * Q_WORDS + STAGES * STAGE_WORDS);
  // two blocks share an SM where their shared memory allows it
  static constexpr int MIN_BLOCKS = 2 * (SMEM + 1024) <= 233472 ? 2 : 1;
  static_assert(SMEM <= 232448, "over the shared memory a block may use");
  static_assert(DQK % 8 == 0 && DVW % 8 == 0 && (STAGES == 1 || STAGES == 2),
                "instance shape");
};

template <int DQK, int DV, int BQ_, int STAGES_>
__global__ void __launch_bounds__(F32Cfg<DQK, DV, BQ_, STAGES_>::THREADS,
                                  F32Cfg<DQK, DV, BQ_, STAGES_>::MIN_BLOCKS)
flash_fwd_f32_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int S, int H, int KV,
                         int causal, int window, float logit_cap, float scale) {
  using C = F32Cfg<DQK, DV, BQ_, STAGES_>;
  constexpr int BK = C::BK, NJ = BK / 8, NN = C::DVW / 8;
  constexpr int RSQ = C::RSQ, RSV = C::RSV, NT = C::THREADS;
  extern __shared__ __align__(16) uint32_t fsmem[];
  uint32_t* Qs = fsmem;                            // [BQ][RSQ] small parts
  uint32_t* Qb = Qs + C::Q_WORDS;                  // [BQ][RSQ] big parts
  float* stages = reinterpret_cast<float*>(Qb + C::Q_WORDS);  // K [BK][RSQ], V [BK][RSV]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = warp % C::ROW_WARPS, ch = warp / C::ROW_WARPS;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::BQ;  // last tiles first
  const size_t q_row = (size_t)H * DQK;   // strides between sequence positions
  const size_t k_row = (size_t)KV * DQK;
  const size_t v_row = (size_t)KV * DV;
  const size_t o_row = (size_t)H * DV;
  const float* qb = q + ((size_t)b * S * H + h) * DQK;
  const float* kb = k + ((size_t)b * S * KV + kvh) * DQK;
  const float* vb = v + ((size_t)b * S * KV + kvh) * DV;

  // the block's live KV tiles: causal -> k_start <= its last row; window ->
  // k_start + BK - 1 > q0 - window (the Pallas block-skip rule)
  const int n_tiles = (S + BK - 1) / BK;
  const int kt_end = causal ? min(n_tiles, min(S - 1, q0 + C::BQ - 1) / BK + 1)
                            : n_tiles;
  int kt_begin = 0;
  if (window > 0) {
    const int lo = q0 - window - BK + 1;  // live iff kt * BK > lo
    kt_begin = lo < 0 ? 0 : lo / BK + 1;
  }
  const int n_kt = kt_end - kt_begin;
  auto load_k = [&](int stage, int kt) {
    sm90::cp_async_rows<DQK, BK, RSQ, NT>(stages + stage * C::STAGE_WORDS, kb,
                                          k_row, kt * BK, S, tid);
  };
  auto load_v = [&](int stage, int kt) {
    sm90::cp_async_rows<DV, BK, RSV, NT>(stages + stage * C::STAGE_WORDS + C::K_WORDS,
                                         vb, v_row, kt * BK, S, tid);
  };
  load_k(0, kt_begin);
  if (C::STAGES == 2) load_v(0, kt_begin);
  sm90::cp_async_commit();

  // Q, scaled in float32, split once into its TF32 planes
  constexpr int QCH = DQK / 4;
  for (int i = tid; i < C::BQ * QCH; i += NT) {
    const int r = i / QCH, c = 4 * (i % QCH), s = q0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s < S) x = __ldg(reinterpret_cast<const float4*>(qb + s * q_row + c));
    uint4 big, small;
    tf32x3::split(x.x * scale, big.x, small.x);
    tf32x3::split(x.y * scale, big.y, small.y);
    tf32x3::split(x.z * scale, big.z, small.z);
    tf32x3::split(x.w * scale, big.w, small.w);
    *reinterpret_cast<uint4*>(Qb + r * RSQ + c) = big;
    *reinterpret_cast<uint4*>(Qs + r * RSQ + c) = small;
  }

  // this warp's rows [wr0, wr1]; its accumulators (tf32x3.cuh's C fragment):
  // element e of 8-column block n sits at row wr0 + g + 8 (e >> 1), column
  // 8 n + 2 t + (e & 1)
  const int wr0 = q0 + 16 * rg, wr1 = min(S - 1, wr0 + 15);
  // ldmatrix row addresses: Q's A fragment (matrix i: rows + 8 (i & 1),
  // columns + 4 (i >> 1)); two of K's B fragments, 8-key blocks 2 jp and
  // 2 jp + 1 (matrix i: keys + 8 (i >> 1), columns + 4 (i & 1))
  const int mi = lane >> 3, mr = lane & 7;
  const uint32_t qa = 4u * ((16 * rg + mr + 8 * (mi & 1)) * RSQ + 4 * (mi >> 1));
  const uint32_t qb_addr = sm90::smem_addr(Qb) + qa;
  const uint32_t qs_addr = sm90::smem_addr(Qs) + qa;
  const uint32_t ka = 4u * ((mr + 8 * (mi >> 1)) * RSQ + 4 * (mi & 1));
  float oacc[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};   // row maxima, log2 units
  float l[2] = {0.f, 0.f};           // this thread's columns only; summed at the end

  for (int it = 0; it < n_kt; ++it) {
    const int kt = kt_begin + it;
    const int stage = C::STAGES == 2 ? (it & 1) : 0;
    sm90::cp_async_wait<0>();  // K(kt) landed (and V(kt) in the ring)
    __syncthreads();           // ... for every thread; P V(kt - 1) is done
    if (C::STAGES == 2) {
      if (it + 1 < n_kt) {
        load_k(stage ^ 1, kt + 1);
        load_v(stage ^ 1, kt + 1);
      }
    } else {
      load_v(0, kt);
    }
    sm90::cp_async_commit();
    const float* Ks = stages + stage * C::STAGE_WORDS;
    const float* Vs = Ks + C::K_WORDS;
    const int k0 = kt * BK;
    // tiles that hold no key of this warp's rows are skipped (warp-uniform)
    const bool live = wr0 < S && !(causal && k0 > wr1) &&
                      !(window > 0 && k0 + BK - 1 <= wr0 - window);

    float sacc[NJ][4], corr[2];
    bool moved = false;
    if (live) {
      // S = (scale q) K^T, 3xTF32: Q's planes as loaded, K split as loaded
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;
      const uint32_t k_addr = sm90::smem_addr(Ks) + ka;
#pragma unroll
      for (int kk = 0; kk < DQK / 8; ++kk) {
        tf32x3::Split<4> a;
        sm90::ldmatrix_x4(a.big, qb_addr + 32 * kk);
        sm90::ldmatrix_x4(a.small, qs_addr + 32 * kk);
#pragma unroll
        for (int jp = 0; jp < NJ / 2; ++jp) {
          uint32_t kr[4];
          sm90::ldmatrix_x4(kr, k_addr + 4 * 16 * jp * RSQ + 32 * kk);
          tf32x3::Split<2> b0, b1;
          tf32x3::split(__uint_as_float(kr[0]), b0.big[0], b0.small[0]);
          tf32x3::split(__uint_as_float(kr[1]), b0.big[1], b0.small[1]);
          tf32x3::split(__uint_as_float(kr[2]), b1.big[0], b1.small[0]);
          tf32x3::split(__uint_as_float(kr[3]), b1.big[1], b1.small[1]);
          tf32x3::mma3(sacc[2 * jp], a, b0);
          tf32x3::mma3(sacc[2 * jp + 1], a, b1);
        }
      }

      // soft-cap, log2(e), mask (only on tiles that cross an edge), row max
      const bool edge = (causal && k0 + BK - 1 > wr0) ||
                        (window > 0 && k0 <= wr1 - window) || k0 + BK > S;
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float s = sacc[j][e];
          s = logit_cap > 0.f ? logit_cap * LOG2E * tanhf(s / logit_cap) : s * LOG2E;
          if (edge) {
            const int qp = wr0 + g + 8 * (e >> 1);
            const int kp = k0 + 8 * j + 2 * t + (e & 1);
            const bool ok = kp < S && (!causal || kp <= qp) &&
                            (window <= 0 || kp > qp - window);
            s = ok ? s : NEG_INF;
          }
          sacc[j][e] = s;
          mx[e >> 1] = fmaxf(mx[e >> 1], s);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        moved |= m_new != m[r];
        corr[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(sacc[j][e] - m[e >> 1]);
          sacc[j][e] = p;
          l[e >> 1] += p;
        }
    }
    if (C::STAGES == 1) {
      sm90::cp_async_wait<0>();  // V(kt) landed
      __syncthreads();           // ... for every thread; S(kt) is done
      if (it + 1 < n_kt) load_k(0, kt + 1);
      sm90::cp_async_commit();
    }
    if (!live) continue;
    // a factor of 1 changes nothing: skip the rescale when no row max moved
    if (__any_sync(0xffffffffu, moved)) {
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[n][e] *= corr[e >> 1];
    }

    // O += P V, 3xTF32: P from the score accumulators in registers (permuted
    // reduction slots), V split as loaded at rows 2 t and 2 t + 1
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const auto pa = tf32x3::acc_as_a(sacc[j]);
#pragma unroll
      for (int n = 0; n < NN; ++n)
        tf32x3::mma3(oacc[n], pa,
                     tf32x3::load_b_perm(Vs, RSV, 8 * j, ch * C::DVW + 8 * n, lane));
    }
  }
  sm90::cp_async_wait<0>();

  if (wr0 >= S) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = wr0 + g + 8 * r;
    if (row >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f), inv = 1.f / denom;
    float* orow = o + ((size_t)b * S + row) * o_row + (size_t)h * DV + ch * C::DVW;
#pragma unroll
    for (int n = 0; n < NN; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n + 2 * t) =
          make_float2(oacc[n][2 * r] * inv, oacc[n][2 * r + 1] * inv);
    // natural log, as the backward reads it: lse = m ln 2 + log l
    if (lse != nullptr && ch == 0 && t == 0)
      lse[((size_t)b * H + h) * S + row] = m[r] * LN2 + logf(denom);
  }
}

template <int DQK, int DV, int BQ_, int STAGES_>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int S, int H, int KV, int causal,
                       int window, float logit_cap, float scale,
                       cudaStream_t stream) {
  using C = F32Cfg<DQK, DV, BQ_, STAGES_>;
  auto kernel = flash_fwd_f32_mma_kernel<DQK, DV, BQ_, STAGES_>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (S + C::BQ - 1) / C::BQ);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), S, H, KV, causal, window, logit_cap, scale);
  return cudaGetLastError();
}

// the (DQK, DV) pairs built: the wrapper's _HEAD_DIMS and _QK_V_PAIRS; the
// float32 instance's query rows a block and K/V stages (its plan test reads
// this table): 128 rows at hd 128, where the shared memory allows no second
// block on an SM; 64 rows elsewhere, so small grids fill the card; one K and
// one V tile (1) where a ring does not fit
template <bool BF16>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     void* lse, int B, int S, int H, int KV, int DQK, int DV,
                     int causal, int window, float logit_cap, float scale,
                     cudaStream_t stream) {
#define REPRO_FLASH_PAIR(dqk, dv, bq, stages)                                 \
  if (DQK == dqk && DV == dv)                                                 \
    return BF16 ? launch_wgmma<dqk, dv>(q, k, v, o, lse, B, S, H, KV, causal, \
                                        window, logit_cap, scale, stream)     \
                : launch_f32<dqk, dv, bq, stages>(q, k, v, o, lse, B, S, H,   \
                                                  KV, causal, window,         \
                                                  logit_cap, scale, stream);
  REPRO_FLASH_PAIR(8, 8, 64, 2)
  REPRO_FLASH_PAIR(16, 16, 64, 2)
  REPRO_FLASH_PAIR(32, 32, 64, 2)
  REPRO_FLASH_PAIR(64, 64, 64, 2)
  REPRO_FLASH_PAIR(80, 80, 64, 2)
  REPRO_FLASH_PAIR(128, 128, 128, 2)
  REPRO_FLASH_PAIR(256, 256, 64, 1)
  REPRO_FLASH_PAIR(192, 128, 64, 2)
  REPRO_FLASH_PAIR(24, 16, 64, 2)
#undef REPRO_FLASH_PAIR
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  is_bf16 selects the
// storage type of q, k, v and o: 1 bfloat16 (wgmma), 0 float32 (3xTF32 mma.sync).
// HD is the head dim of q and k, HDV that of v and o.  lse (float32
// [B, H, S]) is written when it is not null, by either instance.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int is_bf16, int B,
                                   int S, int H, int KV, int HD, int HDV,
                                   int causal, int window, float logit_cap,
                                   float scale, void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<true>(q, k, v, o, lse, B, S, H, KV, HD, HDV, causal,
                          window, logit_cap, scale, st);
  return dispatch<false>(q, k, v, o, lse, B, S, H, KV, HD, HDV, causal, window,
                         logit_cap, scale, st);
}

extern "C" const char* kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
