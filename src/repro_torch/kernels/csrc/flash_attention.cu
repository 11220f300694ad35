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
// (8..256, same) and (192, 128), (24, 16).  Query head h reads KV
// head h / (H / KV), the Pallas index map's b // g.  The ragged edge of S is
// masked here, not padded by the caller.  KV tiles that the causal or window
// mask rules out for the whole query tile are never loaded.
//
// What bounds it: at Llama-3-8B's prefill shape (S=512, H=32, KV=8, HD=128)
// the causal products are 2.15 GFLOP, 2.2 us at the bf16 tensor-core rate,
// against 10.5 MB of q, k, v and o, 3.1 us at 3.35 TB/s: both are small, so
// what the design must avoid is float32 FMAs (67 TFLOP/s, 32 us) and loads
// that stall the products.  Two instances:
//
// bfloat16 (the model path), flash_fwd_wgmma_kernel: one warpgroup (128
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
// 64-column panel; P V writes the V tile's width (at least 64, a legal wgmma
// N) and the output columns past DV are dropped.  At (192, 128) the shared
// memory is the Q tile (24 KB) and two stages of a K (24 KB) and a V (16 KB)
// tile, 107,520 bytes with the alignment pad; at 256 it is 164,864.  The
// grid's y axis walks query tiles from the last, so the causal tiles with the
// most KV tiles start first.
//
// float32, flash_fwd_f32_kernel: float32 FMAs from shared memory, as the
// Pallas kernel computes in float32 throughout (q scaled in float32 before
// the product); float32 tensor cores would be TF32, which cannot meet the
// 2e-5 float32 tolerance.  Thread map (256 threads = a 16 x 16 grid, ty =
// tid / 16, tx = tid % 16): thread (ty, tx) owns query rows ty + 16 i
// (i < 4); for the score tile it owns key columns tx + 16 j (j < 4), for the
// output head-dim columns tx + 16 jj (jj < ceil(DV / 16); at DV = 8 the
// threads with tx >= 8 own none).  The 16 threads of one row sit in one
// half-warp, so row max and row sum are xor-shuffles over lane offsets 8, 4,
// 2, 1.  Q and K tiles are stored with a row stride of DQK + 1 floats so
// that the 16 key columns of a half-warp fall in 16 different banks.  Shared
// memory is 4 (64 (DQK+1) + 64 (DQK+1) + 64 DV + 64 * 65) bytes: 213,760 at
// 256, 148,224 at (192, 128), under the 232,448 a Hopper block may opt into.
// Given an lse pointer (training: the backward in flash_attention_bwd.cu
// recomputes the probabilities from it), the float32 instance also writes
// each row's log-sum-exp m + log(l) [B, H, S]; serving passes none, and o
// does not depend on it.

#include <stdint.h>

#include "sm90.cuh"

namespace {

namespace sm90 = repro_torch::sm90;
using bf16 = __nv_bfloat16;

constexpr int BQ = 64;          // query rows per block
constexpr float NEG_INF = -2.0e38f;  // the Pallas kernel's mask value
constexpr float LOG2E = 1.4426950408889634f;

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
                       int S, int H, int KV, int causal, int window,
                       float logit_cap, float scale) {
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
}

template <int DQK, int DV>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o,
                         int B, int S, int H, int KV, int causal, int window,
                         float logit_cap, float scale, cudaStream_t stream) {
  constexpr int smem = TcCfg<DQK, DV>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<DQK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  flash_fwd_wgmma_kernel<DQK, DV><<<grid, 128, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), S, H, KV, causal,
      window, logit_cap, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 256;

template <int DQK, int DV>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (DQK + 1) + BK * (DQK + 1) + BK * DV + BQ * (BK + 1));
}

template <int DQK, int DV>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int S, int H, int KV, int causal,
                     int window, float logit_cap, float scale) {
  constexpr int QS = DQK + 1;    // row stride of the Q and K tiles
  constexpr int PS = BK + 1;     // row stride of the P tile
  constexpr int DJ = (DV + 15) / 16;  // output columns per thread (at most)
  extern __shared__ float smem[];
  float* Qs = smem;              // [BQ][QS], already scaled
  float* Ks = Qs + BQ * QS;      // [BK][QS]
  float* Vs = Ks + BK * QS;      // [BK][DV]
  float* Ps = Vs + BK * DV;      // [BQ][PS]
  // this thread's output columns tx + 16 jj exist (DV < 16: only tx < DV)
  const bool has_col = DV % 16 == 0 || threadIdx.x % 16 < DV % 16;

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * BQ;
  const size_t q_row = (size_t)H * DQK;   // strides between sequence positions
  const size_t k_row = (size_t)KV * DQK;
  const size_t v_row = (size_t)KV * DV;
  const size_t o_row = (size_t)H * DV;
  const float* qb = q + ((size_t)b * S * H + h) * DQK;
  const float* kb = k + ((size_t)b * S * KV + kvh) * DQK;
  const float* vb = v + ((size_t)b * S * KV + kvh) * DV;
  float* ob = o + ((size_t)b * S * H + h) * DV;

  for (int i = tid; i < BQ * DQK; i += THREADS) {
    const int r = i / DQK, d = i % DQK, s = q0 + r;
    Qs[r * QS + d] = s < S ? qb[s * q_row + d] * scale : 0.f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = 0.f;
  }

  // live KV tiles: causal -> k_start <= last query row of the tile;
  // window -> k_start + BK - 1 > q0 - window (the Pallas block-skip rule)
  const int n_tiles = (S + BK - 1) / BK;
  const int kt_end = causal ? min(n_tiles, (q0 + BQ - 1) / BK + 1) : n_tiles;
  int kt_begin = 0;
  if (window > 0) {
    const int lo = q0 - window - BK + 1;  // live iff kt * BK > lo
    kt_begin = lo < 0 ? 0 : lo / BK + 1;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done (and Qs is written)
    for (int i = tid; i < BK * DQK; i += THREADS) {
      const int r = i / DQK, d = i % DQK, s = k0 + r;
      Ks[r * QS + d] = s < S ? kb[s * k_row + d] : 0.f;
    }
    for (int i = tid; i < BK * DV; i += THREADS) {
      const int r = i / DV, d = i % DV, s = k0 + r;
      Vs[r * DV + d] = s < S ? vb[s * v_row + d] : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DQK; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float rmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        float s = sc[i][j];
        if (logit_cap > 0.f) s = logit_cap * tanhf(s / logit_cap);
        const bool ok = kp < S && (!causal || kp <= qp) &&
                        (window <= 0 || kp > qp - window);
        s = ok ? s : NEG_INF;
        sc[i][j] = s;
        rmax = fmaxf(rmax, s);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float corr = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        sc[i][j] = p;
        rsum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * corr + rsum;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) acc[i][jj] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty + 16 * i) * PS + tx + 16 * j] = sc[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj)
        vv[jj] = has_col ? Vs[c * DV + tx + 16 * jj] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = fmaf(pv[i], vv[jj], acc[i][jj]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s < S && has_col) {
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj)
        ob[s * o_row + tx + 16 * jj] = acc[i][jj] / denom;
    }
    // m and l are the same in the 16 threads of the row
    if (lse != nullptr && s < S && tx == 0)
      lse[((size_t)b * H + h) * S + s] = m[i] + logf(fmaxf(l[i], 1e-30f));
  }
}

template <int DQK, int DV>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int S, int H, int KV, int causal,
                       int window, float logit_cap, float scale,
                       cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DQK, DV>();
  static_assert(smem <= 232448, "over the shared memory a block may use");
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<DQK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd_f32_kernel<DQK, DV><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), S, H, KV, causal, window, logit_cap, scale);
  return cudaGetLastError();
}

// the (DQK, DV) pairs built: the wrapper's _HEAD_DIMS and _QK_V_PAIRS
template <bool BF16>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     void* lse, int B, int S, int H, int KV, int DQK, int DV,
                     int causal, int window, float logit_cap, float scale,
                     cudaStream_t stream) {
#define REPRO_FLASH_PAIR(dqk, dv)                                             \
  if (DQK == dqk && DV == dv)                                                 \
    return BF16 ? launch_wgmma<dqk, dv>(q, k, v, o, B, S, H, KV, causal,      \
                                        window, logit_cap, scale, stream)     \
                : launch_f32<dqk, dv>(q, k, v, o, lse, B, S, H, KV, causal,   \
                                      window, logit_cap, scale, stream);
  REPRO_FLASH_PAIR(8, 8)
  REPRO_FLASH_PAIR(16, 16)
  REPRO_FLASH_PAIR(32, 32)
  REPRO_FLASH_PAIR(64, 64)
  REPRO_FLASH_PAIR(128, 128)
  REPRO_FLASH_PAIR(256, 256)
  REPRO_FLASH_PAIR(192, 128)
  REPRO_FLASH_PAIR(24, 16)
#undef REPRO_FLASH_PAIR
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  is_bf16 selects the
// storage type of q, k, v and o: 1 bfloat16 (tensor-core kernel), 0 float32.
// HD is the head dim of q and k, HDV that of v and o.  lse (float32
// [B, H, S]) is written when it is not null; only the float32 instance takes
// one.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int is_bf16, int B,
                                   int S, int H, int KV, int HD, int HDV,
                                   int causal, int window, float logit_cap,
                                   float scale, void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0) return cudaErrorInvalidValue;
  if (is_bf16 && lse != nullptr) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<true>(q, k, v, o, nullptr, B, S, H, KV, HD, HDV, causal,
                          window, logit_cap, scale, st);
  return dispatch<false>(q, k, v, o, lse, B, S, H, KV, HD, HDV, causal, window,
                         logit_cap, scale, st);
}

extern "C" const char* kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
