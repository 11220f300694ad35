// Backward of K1 (flash prefill attention) for Hopper (sm_90a), float32.
//
// The reference trains by differentiating its XLA attention
// (src/repro/models/attention.py::chunked_attention, the function the Pallas
// TPU kernel src/repro/kernels/flash_attention.py::flash_attention computes);
// the port's model path runs K1 in every attention layer, so the gradient of
// K1's function needs a kernel of its own.  It takes what the float32
// forward (flash_attention.cu, flash_fwd_f32_kernel) leaves: q, k, v, o and
// the row log-sum-exp lse [B, H, S] of the scaled, soft-capped, masked
// scores, and the output gradient dO, all in the model layout (q, o, dO
// [B, S, H, HD], k, v [B, S, KV, HD]), and writes dQ, dK, dV in the layouts
// of q, k, v.  It recomputes the probabilities from lse instead of storing
// the S x S matrix:
//
//   s  = (scale q) . k                      raw score
//   sc = cap tanh(s / cap)  (or s)          soft-capped score
//   P  = exp(sc - lse) where the mask keeps (causal, window, ragged S), else 0
//   D  = rowsum(dO o O)                     one number a query row
//   dV = P^T dO,   dP = dO V^T,   dS = P (dP - D) (1 - tanh^2(s / cap))
//   dQ = scale dS K,   dK = dS^T (scale q)
//
// with dK and dV summed over the G = H / KV query heads that read one KV head
// (GQA).  Three launches: flash_bwd_dot_kernel (D, one warp a row),
// flash_bwd_dkdv_kernel (one block per (batch * KV head, 64-key tile), which
// walks the G query heads and the query tiles that can see its keys and keeps
// dK and dV of its 64 keys in registers), and flash_bwd_dq_kernel (one block
// per (batch * head, 64-row query tile), which walks the key tiles its rows
// can see and keeps dQ in registers).  Every output element is written by one
// thread after a fixed-order sum: no float atomics, so two runs give the same
// bits.  Tiles the causal or window mask rules out whole are never loaded.
//
// What bounds it: at Llama-3-8B's training shape (B=2, S=512, H=32, KV=8,
// HD=128) the five products of the causal pairs (s, dP, dV, dK, dQ) are
// 10.8 GFLOP, 161 us at the float32 CUDA-core rate of 67 TFLOP/s, against
// 84 MB of q, k, v, o, dO, lse, dQ, dK and dV, 25 us at 3.35 TB/s: the
// float32 products bound it (float32 tensor cores would be TF32, which cannot
// meet the float32 tolerance).  The design is the forward's: float32 FMAs from
// shared memory, a 16 x 16 grid of 256 threads over a 64 x 64 score tile, each
// thread owning 4 x 4 scores and 4 rows of HD / 16 output columns; tiles
// stored with a row stride of HD + 1 floats so the 16 threads of a half-warp
// read 16 banks.  s and dP are recomputed by both the dK/dV and the dQ
// kernels (seven products, not five): the price of writing each output once.
// Shared memory at HD = 128: 165,888 bytes (dK/dV), 149,248 (dQ).

#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 256;    // a 16 x 16 grid: ty = tid / 16, tx = tid % 16
constexpr int PS = 65;          // row stride of the 64 x 64 probability tiles

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
constexpr size_t dkdv_smem() {
  return sizeof(float) * (4 * 64 * (HD + 1) + 2 * 64 * PS + 2 * BQ);
}

template <int HD>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * 64 * (HD + 1) + BQ * PS + 2 * BQ);
}

// one block: 64 keys of one (batch, KV head); thread (ty, tx) owns keys
// ty + 16 i (i < 4) and, for dK / dV, columns tx + 16 jj
template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, int S, int H, int KV, int causal,
                      int window, float logit_cap, float scale) {
  constexpr int RS = HD + 1;              // row stride of the HD-wide tiles
  constexpr int DJ = (HD + 15) / 16;      // output columns per thread (at most)
  extern __shared__ float smem[];
  float* Ks = smem;                       // [BK][RS]
  float* Vs = Ks + BK * RS;               // [BK][RS]
  float* Qs = Vs + BK * RS;               // [BQ][RS], scaled
  float* dOs = Qs + BQ * RS;              // [BQ][RS]
  float* Pt = dOs + BQ * RS;              // [BK][PS]: P transposed
  float* dSt = Pt + BK * PS;              // [BK][PS]: dS transposed
  float* Ls = dSt + BK * PS;              // [BQ] lse
  float* Ds = Ls + BQ;                    // [BQ] D
  const bool has_col = HD % 16 == 0 || threadIdx.x % 16 < HD % 16;

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int k0 = blockIdx.x * BK;
  const int b = blockIdx.y / KV;
  const int kvh = blockIdx.y % KV;
  const int G = H / KV;
  const size_t q_row = (size_t)H * HD;    // strides between sequence positions
  const size_t k_row = (size_t)KV * HD;
  const float* kb = k + ((size_t)b * S * KV + kvh) * HD;
  const float* vb = v + ((size_t)b * S * KV + kvh) * HD;

  for (int i = tid; i < BK * HD; i += THREADS) {
    const int r = i / HD, d = i % HD, s = k0 + r;
    Ks[r * RS + d] = s < S ? kb[s * k_row + d] : 0.f;
    Vs[r * RS + d] = s < S ? vb[s * k_row + d] : 0.f;
  }

  float dk_acc[4][DJ], dv_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) dk_acc[i][jj] = dv_acc[i][jj] = 0.f;

  // query tiles that can see a key of this tile: causal -> from the key
  // tile's own rows on; window -> up to the last key + window - 1
  const int n_tiles = (S + BQ - 1) / BQ;
  const int qt_begin = causal ? k0 / BQ : 0;
  int qt_end = n_tiles;
  if (window > 0) qt_end = min(n_tiles, (k0 + BK - 2 + window) / BQ + 1);

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const float* qb = q + ((size_t)b * S * H + h) * HD;
    const float* db = dout + ((size_t)b * S * H + h) * HD;
    const float* lb = lse + ((size_t)b * H + h) * S;
    const float* deb = delta + ((size_t)b * H + h) * S;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous tile's readers are done (Ks, Vs written)
      for (int i = tid; i < BQ * HD; i += THREADS) {
        const int r = i / HD, d = i % HD, s = q0 + r;
        Qs[r * RS + d] = s < S ? qb[s * q_row + d] * scale : 0.f;
        dOs[r * RS + d] = s < S ? db[s * q_row + d] : 0.f;
      }
      if (tid < BQ) {
        const int s = q0 + tid;
        Ls[tid] = s < S ? lb[s] : 0.f;
        Ds[tid] = s < S ? deb[s] : 0.f;
      }
      __syncthreads();

      // transposed tiles: rows are keys ty + 16 i, columns queries tx + 16 j
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float kv[4], qv[4], vv[4], ov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = Ks[(ty + 16 * i) * RS + d];
          vv[i] = Vs[(ty + 16 * i) * RS + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = Qs[(tx + 16 * j) * RS + d];
          ov[j] = dOs[(tx + 16 * j) * RS + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            // the forward's order: fmaf(q, k, acc) over d
            st[i][j] = fmaf(qv[j], kv[i], st[i][j]);
            dpt[i][j] = fmaf(ov[j], vv[i], dpt[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kr = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qc = tx + 16 * j;
          float p, ds;
          prob_and_ds(st[i][j], Ls[qc], Ds[qc], dpt[i][j],
                      live(q0 + qc, k0 + kr, S, causal, window), logit_cap, &p,
                      &ds);
          Pt[kr * PS + qc] = p;
          dSt[kr * PS + qc] = ds;
        }
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T (scale q)
#pragma unroll 4
      for (int c = 0; c < BQ; ++c) {
        float pv[4], sv[4], ov[DJ], qv[DJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = Pt[(ty + 16 * i) * PS + c];
          sv[i] = dSt[(ty + 16 * i) * PS + c];
        }
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) {
          ov[jj] = has_col ? dOs[c * RS + tx + 16 * jj] : 0.f;
          qv[jj] = has_col ? Qs[c * RS + tx + 16 * jj] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < DJ; ++jj) {
            dv_acc[i][jj] = fmaf(pv[i], ov[jj], dv_acc[i][jj]);
            dk_acc[i][jj] = fmaf(sv[i], qv[jj], dk_acc[i][jj]);
          }
      }
    }
  }

  float* dkb = dk + ((size_t)b * S * KV + kvh) * HD;
  float* dvb = dv + ((size_t)b * S * KV + kvh) * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = k0 + ty + 16 * i;
    if (s < S && has_col) {
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        dkb[s * k_row + tx + 16 * jj] = dk_acc[i][jj];
        dvb[s * k_row + tx + 16 * jj] = dv_acc[i][jj];
      }
    }
  }
}

// one block: 64 query rows of one (batch, head); thread (ty, tx) owns rows
// ty + 16 i and, for dQ, columns tx + 16 jj
template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int S, int H, int KV, int causal, int window,
                    float logit_cap, float scale) {
  constexpr int RS = HD + 1;
  constexpr int DJ = (HD + 15) / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                       // [BQ][RS], scaled
  float* dOs = Qs + BQ * RS;              // [BQ][RS]
  float* Ks = dOs + BQ * RS;              // [BK][RS]
  float* Vs = Ks + BK * RS;               // [BK][RS]
  float* dSs = Vs + BK * RS;              // [BQ][PS]
  float* Ls = dSs + BQ * PS;              // [BQ]
  float* Ds = Ls + BQ;                    // [BQ]
  const bool has_col = HD % 16 == 0 || threadIdx.x % 16 < HD % 16;

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kvh = h / (H / KV);
  const size_t q_row = (size_t)H * HD;
  const size_t k_row = (size_t)KV * HD;
  const float* qb = q + ((size_t)b * S * H + h) * HD;
  const float* db = dout + ((size_t)b * S * H + h) * HD;
  const float* kb = k + ((size_t)b * S * KV + kvh) * HD;
  const float* vb = v + ((size_t)b * S * KV + kvh) * HD;

  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int r = i / HD, d = i % HD, s = q0 + r;
    Qs[r * RS + d] = s < S ? qb[s * q_row + d] * scale : 0.f;
    dOs[r * RS + d] = s < S ? db[s * q_row + d] : 0.f;
  }
  if (tid < BQ) {
    const int s = q0 + tid;
    Ls[tid] = s < S ? lse[((size_t)b * H + h) * S + s] : 0.f;
    Ds[tid] = s < S ? delta[((size_t)b * H + h) * S + s] : 0.f;
  }

  float dq_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) dq_acc[i][jj] = 0.f;

  // the forward's live key tiles
  const int n_tiles = (S + BK - 1) / BK;
  const int kt_end = causal ? min(n_tiles, (q0 + BQ - 1) / BK + 1) : n_tiles;
  int kt_begin = 0;
  if (window > 0) {
    const int lo = q0 - window - BK + 1;  // live iff kt * BK > lo
    kt_begin = lo < 0 ? 0 : lo / BK + 1;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done (Qs, dOs written)
    for (int i = tid; i < BK * HD; i += THREADS) {
      const int r = i / HD, d = i % HD, s = k0 + r;
      Ks[r * RS + d] = s < S ? kb[s * k_row + d] : 0.f;
      Vs[r * RS + d] = s < S ? vb[s * k_row + d] : 0.f;
    }
    __syncthreads();

    float sc[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty + 16 * i) * RS + d];
        ov[i] = dOs[(ty + 16 * i) * RS + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 16 * j) * RS + d];
        vv[j] = Vs[(tx + 16 * j) * RS + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = tx + 16 * j;
        float p, ds;
        prob_and_ds(sc[i][j], Ls[qr], Ds[qr], dp[i][j],
                    live(q0 + qr, k0 + kc, S, causal, window), logit_cap, &p, &ds);
        dSs[qr * PS + kc] = ds;
      }
    }
    __syncthreads();

    // dQ += dS K
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float sv[4], kv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = dSs[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj)
        kv[jj] = has_col ? Ks[c * RS + tx + 16 * jj] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) dq_acc[i][jj] = fmaf(sv[i], kv[jj], dq_acc[i][jj]);
    }
  }

  float* dqb = dq + ((size_t)b * S * H + h) * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s < S && has_col) {
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) dqb[s * q_row + tx + 16 * jj] = dq_acc[i][jj] * scale;
    }
  }
}

template <int HD>
cudaError_t launch_bwd(const float* q, const float* k, const float* v,
                       const float* o, const float* lse, const float* dout,
                       float* delta, float* dq, float* dk, float* dv, int B,
                       int S, int H, int KV, int causal, int window,
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
  const dim3 grid_kv((S + BK - 1) / BK, B * KV);
  flash_bwd_dkdv_kernel<HD><<<grid_kv, THREADS, smem_kv, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, S, H, KV, causal, window, logit_cap,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_q((S + BQ - 1) / BQ, B * H);
  flash_bwd_dq_kernel<HD><<<grid_q, THREADS, smem_q, stream>>>(
      q, k, v, dout, lse, delta, dq, S, H, KV, causal, window, logit_cap, scale);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launches (0 on success).  All pointers are
// contiguous float32: q, o, dout, dq [B, S, H, HD]; k, v, dk, dv
// [B, S, KV, HD]; lse and the scratch delta [B, H, S].  HD is 8, 16, 32, 64
// or 128 (the wrapper's _BWD_HEAD_DIMS).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const void* lse,
                                   const void* dout, void* delta, void* dq,
                                   void* dk, void* dv, int B, int S, int H,
                                   int KV, int HD, int causal, int window,
                                   float logit_cap, float scale, void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH_BWD(hd)                                                   \
  if (HD == hd)                                                               \
    return launch_bwd<hd>(                                                    \
        static_cast<const float*>(q), static_cast<const float*>(k),           \
        static_cast<const float*>(v), static_cast<const float*>(o),           \
        static_cast<const float*>(lse), static_cast<const float*>(dout),      \
        static_cast<float*>(delta), static_cast<float*>(dq),                  \
        static_cast<float*>(dk), static_cast<float*>(dv), B, S, H, KV,        \
        causal, window, logit_cap, scale, st);
  REPRO_FLASH_BWD(8)
  REPRO_FLASH_BWD(16)
  REPRO_FLASH_BWD(32)
  REPRO_FLASH_BWD(64)
  REPRO_FLASH_BWD(128)
#undef REPRO_FLASH_BWD
  return cudaErrorInvalidValue;
}
