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
// Layout: q/o are contiguous [B, S, H, HD], k/v contiguous [B, S, KV, HD],
// the model layout, so the caller transposes nothing.  Query head h reads KV
// head h / (H / KV), the Pallas index map's b // g.  The ragged edge of S is
// masked here, not padded by the caller.  KV tiles that the causal or window
// mask rules out for the whole query tile are never loaded.
//
// Products are float32 FMAs from shared memory, as the Pallas kernel computes
// in float32 throughout (q is scaled in float32 before the product).  This
// first version uses no tensor cores; wgmma/TMA is later work.
//
// Thread map (256 threads = a 16 x 16 grid, ty = tid / 16, tx = tid % 16):
// thread (ty, tx) owns query rows ty + 16 i (i < 4); for the score tile it
// owns key columns tx + 16 j (j < 4), for the output head-dim columns
// tx + 16 jj (jj < HD / 16).  The 16 threads of one row sit in one half-warp,
// so row max and row sum are xor-shuffles over lane offsets 8, 4, 2, 1.
// Q and K tiles are stored with a row stride of HD + 1 floats so that the 16
// key columns of a half-warp fall in 16 different banks.
//
// Shared memory is 4 (64 (HD+1) + 64 (HD+1) + 64 HD + 64 * 65) bytes: 213,760
// at HD = 256 (Griffin's local attention), under the 232,448 a Hopper block
// may opt into, so the same tiling holds there with one block per SM.

#include <stdint.h>

#include "common.cuh"

namespace {

using repro_torch::from_f32;
using repro_torch::to_f32;

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 256;
constexpr float NEG_INF = -2.0e38f;  // the Pallas kernel's mask value

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int H,
                 int KV, int causal, int window, float logit_cap, float scale) {
  constexpr int QS = HD + 1;     // row stride of the Q and K tiles
  constexpr int PS = BK + 1;     // row stride of the P tile
  constexpr int DJ = HD / 16;    // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;              // [BQ][QS], already scaled
  float* Ks = Qs + BQ * QS;      // [BK][QS]
  float* Vs = Ks + BK * QS;      // [BK][HD]
  float* Ps = Vs + BK * HD;      // [BQ][PS]

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * BQ;
  const size_t q_row = (size_t)H * HD;    // stride between sequence positions
  const size_t kv_row = (size_t)KV * HD;
  const T* qb = q + ((size_t)b * S * H + h) * HD;
  const T* kb = k + ((size_t)b * S * KV + kvh) * HD;
  const T* vb = v + ((size_t)b * S * KV + kvh) * HD;
  T* ob = o + ((size_t)b * S * H + h) * HD;

  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int r = i / HD, d = i % HD, s = q0 + r;
    Qs[r * QS + d] = s < S ? to_f32(qb[s * q_row + d]) * scale : 0.f;
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
    for (int i = tid; i < BK * HD; i += THREADS) {
      const int r = i / HD, d = i % HD, s = k0 + r;
      const bool in = s < S;
      Ks[r * QS + d] = in ? to_f32(kb[s * kv_row + d]) : 0.f;
      Vs[r * HD + d] = in ? to_f32(vb[s * kv_row + d]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
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
      for (int jj = 0; jj < DJ; ++jj) vv[jj] = Vs[c * HD + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = fmaf(pv[i], vv[jj], acc[i][jj]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s < S) {
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj)
        ob[s * q_row + tx + 16 * jj] = from_f32<T>(acc[i][jj] / denom);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int S, int H, int KV, int causal, int window,
                   float logit_cap, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, KV, causal, window,
      logit_cap, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int H, int KV, int HD, int causal,
                        int window, float logit_cap, float scale,
                        cudaStream_t stream) {
  switch (HD) {
    case 16: return launch<T, 16>(q, k, v, o, B, S, H, KV, causal, window, logit_cap, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, S, H, KV, causal, window, logit_cap, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, KV, causal, window, logit_cap, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, S, H, KV, causal, window, logit_cap, scale, stream);
    case 256: return launch<T, 256>(q, k, v, o, B, S, H, KV, causal, window, logit_cap, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  is_bf16 selects the
// storage type of q, k, v and o: 1 bfloat16, 0 float32.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int is_bf16, int B, int S, int H,
                                   int KV, int HD, int causal, int window,
                                   float logit_cap, float scale, void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_hd<__nv_bfloat16>(q, k, v, o, B, S, H, KV, HD, causal,
                                      window, logit_cap, scale, st);
  return dispatch_hd<float>(q, k, v, o, B, S, H, KV, HD, causal, window,
                            logit_cap, scale, st);
}

extern "C" const char* kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
