// Mamba-2 SSD chunk scan for Hopper (sm_90a): chunked state-space duality
// with a carried float32 state.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_chunk.py (_ssd_kernel,
// called by ssd_chunk).  Per chunk of Q steps of one (batch, head):
//   cums = cumsum(dt * A)
//   y    = ((C B^T) o L) (dt x) + (C o e^cums) S,  L[i,j] = e^(cums_i - cums_j), j <= i
//   S   <- S e^cums[-1] + (B o e^(cums[-1] - cums))^T (dt x)
// with S the [N, P] float32 state carried across chunks.  The TPU kernel
// carries S in VMEM along its sequential minor grid axis and starts from
// zero; the model path (src/repro/models/mamba2.py::ssd_chunked) also seeds
// S from a given state and returns the final one, so this kernel does both.
//
// Two kernels per call:
//  1. ssd_cb_kernel: C B^T for every chunk, once per (batch, group), in
//     64 x 64 tiles on and below the diagonal (tiles above it are never
//     read).  B and C are per group, so all H / G heads of a group share
//     it; only L is per head.
//  2. ssd_scan_kernel: one block per (batch * head, 16 columns of P).  The
//     columns of the state are independent (y[:, p] needs only S[:, p] and
//     (dt x)[:, p]), so a head's state splits across P / 16 blocks: 256
//     blocks at the serving shape (B=1, H=64, P=64) for the 132 SMs, where
//     one block per head would leave half of them idle.  Each block walks
//     its chunks in order with its [N, 16] slice of S in shared memory.
//     The Q x Q score tile never exists whole: the block builds 64 x 64
//     tiles of (C B^T) o L from the tiles of kernel 1 and skips those above
//     the diagonal.  L is masked before exp (for j > i, cums_i - cums_j can
//     be positive and exp overflow; inf * 0 would be NaN).
//
// Layout: x [B, S, H, P] and B/C [B, S, G, N] with their last two dims
// contiguous and any stride between batch rows and positions (the model
// passes slices of the conv output); dt [B, S, H] float32; A [H] float32;
// y [B, S, H, P] contiguous in x's type; states [B, H, N, P] float32.  Query
// head h reads group h / (H / G).  The ragged S edge is masked here: steps
// past S have dt = 0 in the reference's padding, which leaves the state
// unchanged, so masking gives the same final state.
//
// Arithmetic is float32 throughout, as the Pallas kernel's
// preferred_element_type=float32, with IEEE expf (no fast math).  Products
// are CUDA-core FMAs from shared memory; tensor cores are later work.  What
// bounds it on the H100: bytes (10.8 MB at the Mamba-2 prefill shape, 3.2
// us, against ~1.6 GFLOP of products that input needs, 1.7 us at the bf16
// tensor rate).  This first version runs far above that bound: it spends
// its time in float32 FMAs fed from shared memory.

#include <stdint.h>

#include "common.cuh"

namespace {

using repro_torch::from_f32;
using repro_torch::to_f32;

constexpr int THREADS = 256;
constexpr int TILE = 64;   // rows of a C / B tile, and the side of a score tile
constexpr int PT = 16;     // state columns (of P) per scan block
constexpr int KC = 32;     // N slab of kernel 1
constexpr int MAXK = 16;   // state rows per thread: N <= 16 * MAXK = 256

// ---------------------------------------------------------------------------
// kernel 1: cb[bg][c][i][j] = sum_n C[b, c Q + i, g, n] * B[b, c Q + j, g, n]
// grid (tile pairs it >= jt, chunks, B * G); a thread owns a 4 x 4 block of
// the 64 x 64 tile: rows ty + 16 r, columns tx + 16 c.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_cb_kernel(const T* __restrict__ bm, const T* __restrict__ cm,
              float* __restrict__ cb, int S, int G, int N, int Q, int nc,
              long long b_sb, long long b_ss, long long c_sb, long long c_ss) {
  __shared__ float Cs[TILE][KC + 1];
  __shared__ float Bs[TILE][KC + 1];
  int t = blockIdx.x, it = 0;
  while ((it + 1) * (it + 2) / 2 <= t) ++it;
  const int jt = t - it * (it + 1) / 2;
  const int c = blockIdx.y;
  const int bg = blockIdx.z;
  const int b = bg / G, g = bg % G;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int i0 = it * TILE, j0 = jt * TILE, c0 = c * Q;
  const T* cbase = cm + b * c_sb + (long long)g * N;
  const T* bbase = bm + b * b_sb + (long long)g * N;

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;

  for (int k0 = 0; k0 < N; k0 += KC) {
    __syncthreads();
    for (int e = tid; e < TILE * KC; e += THREADS) {
      const int r = e / KC, k = e % KC, n = k0 + k;
      const int i = i0 + r, j = j0 + r;
      Cs[r][k] = (i < Q && c0 + i < S && n < N) ? to_f32(cbase[(c0 + i) * c_ss + n]) : 0.f;
      Bs[r][k] = (j < Q && c0 + j < S && n < N) ? to_f32(bbase[(c0 + j) * b_ss + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < KC; ++k) {
      float cv[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) cv[r] = Cs[ty + 16 * r][k];
#pragma unroll
      for (int q = 0; q < 4; ++q) bv[q] = Bs[tx + 16 * q][k];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(cv[r], bv[q], acc[r][q]);
    }
  }
  float* out = cb + ((size_t)bg * nc + c) * Q * Q;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
    if (i >= Q) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + tx + 16 * q;
      if (j < Q) out[(size_t)i * Q + j] = acc[r][q];
    }
  }
}

// ---------------------------------------------------------------------------
// kernel 2: the chunk scan.  grid (ceil(P / PT), B * H).  Thread (rr, pp) =
// (tid / 16, tid % 16) owns state column p0 + pp; for y it owns rows
// rr + 16 k of a 64-row tile, for the state rows n = rr + 16 k.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ cb,
                const T* __restrict__ bm, const T* __restrict__ cm,
                const float* __restrict__ state_in, T* __restrict__ y,
                float* __restrict__ state_out, int S, int H, int G, int N,
                int P, int Q, int nc, long long x_sb, long long x_ss,
                long long b_sb, long long b_ss, long long c_sb, long long c_ss) {
  constexpr int MS = TILE + 1;  // row stride of the score tile
  const int NS = N + 1;         // row stride of the C / B tile
  extern __shared__ float smem[];
  float* cums = smem;               // [Q]   inclusive cumsum of dt * A
  float* ein = cums + Q;            // [Q]   e^cums
  float* eout = ein + Q;            // [Q]   e^(cums[-1] - cums)
  float* xbar = eout + Q;           // [Q][PT]  dt * x
  float* st = xbar + Q * PT;        // [N][PT]  the carried state's columns
  float* tile = st + N * PT;        // [TILE][NS] rows of C or of B
  float* Ms = tile + TILE * NS;     // [TILE][MS] (C B^T) o L

  const int tid = threadIdx.x;
  const int rr = tid / PT, pp = tid % PT;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int g = h / (H / G);
  const int p0 = blockIdx.x * PT;
  const bool pcol = p0 + pp < P;
  const float a = A[h];
  const T* xb = x + b * x_sb + (long long)h * P;
  const T* bb = bm + b * b_sb + (long long)g * N;
  const T* cbb = cm + b * c_sb + (long long)g * N;
  const float* dtb = dt + (size_t)b * S * H + h;
  T* yb = y + ((size_t)b * S * H + h) * P;

  for (int e = tid; e < N * PT; e += THREADS) {
    const int n = e / PT, q = e % PT;
    st[e] = (state_in != nullptr && p0 + q < P)
                ? state_in[((size_t)bh * N + n) * P + p0 + q] : 0.f;
  }

  for (int c = 0; c < nc; ++c) {
    const int c0 = c * Q;
    const int len = min(Q, S - c0);
    __syncthreads();  // the previous chunk is done with every buffer

    // cums: warp 0; lane l scans a contiguous run of Q / 32, then the runs'
    // totals are scanned across the warp.  Steps past len have dt = 0.
    if (tid < 32) {
      const int per = (Q + 31) / 32, s0 = tid * per;
      float run = 0.f;
      for (int k = 0; k < per; ++k) {
        const int i = s0 + k;
        if (i < Q) {
          run += i < len ? dtb[(size_t)(c0 + i) * H] * a : 0.f;
          cums[i] = run;
        }
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.f;
      for (int k = 0; k < per; ++k) {
        const int i = s0 + k;
        if (i < Q) cums[i] += excl;
      }
    }
    for (int e = tid; e < Q * PT; e += THREADS) {
      const int j = e / PT, q = e % PT;
      xbar[e] = (j < len && p0 + q < P)
                    ? to_f32(xb[(c0 + j) * x_ss + p0 + q]) * dtb[(size_t)(c0 + j) * H]
                    : 0.f;
    }
    __syncthreads();
    const float last = cums[Q - 1];
    for (int i = tid; i < Q; i += THREADS) {
      ein[i] = expf(cums[i]);
      eout[i] = expf(last - cums[i]);
    }

    // ---- y, one 64-row tile at a time ----
    const float* cbc = cb + ((size_t)(b * G + g) * nc + c) * Q * Q;
    const int ntile = (len + TILE - 1) / TILE;
    for (int it = 0; it < ntile; ++it) {
      const int i0 = it * TILE;
      __syncthreads();
      for (int e = tid; e < TILE * N; e += THREADS) {
        const int r = e / N, n = e % N, i = i0 + r;
        tile[r * NS + n] = i < len ? to_f32(cbb[(c0 + i) * c_ss + n]) : 0.f;
      }
      __syncthreads();
      // carried state: (C S)[i, p] e^cums_i
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int n = 0; n < N; ++n) {
        const float sv = st[n * PT + pp];
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k] = fmaf(tile[(rr + 16 * k) * NS + n], sv, acc[k]);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = i0 + rr + 16 * k;
        acc[k] *= i < Q ? ein[i] : 0.f;
      }
      // within the chunk: sum over j <= i of ((C B^T) o L)[i, j] (dt x)[j, p]
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * TILE;
        __syncthreads();
        for (int e = tid; e < TILE * TILE; e += THREADS) {
          const int r = e / TILE, q = e % TILE, i = i0 + r, j = j0 + q;
          // mask before exp: only j <= i < len is ever exponentiated
          Ms[r * MS + q] = (j <= i && i < len)
                               ? cbc[(size_t)i * Q + j] * expf(cums[i] - cums[j])
                               : 0.f;
        }
        __syncthreads();
        const int jn = min(TILE, len - j0);
        for (int jj = 0; jj < jn; ++jj) {
          const float xv = xbar[(j0 + jj) * PT + pp];
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[k] = fmaf(Ms[(rr + 16 * k) * MS + jj], xv, acc[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = i0 + rr + 16 * k;
        if (i < len && pcol) yb[(size_t)(c0 + i) * H * P + p0 + pp] = from_f32<T>(acc[k]);
      }
    }

    // ---- state: S e^cums[-1] + (B o e^(cums[-1] - cums))^T (dt x) ----
    const float dlast = expf(last);
    float sacc[MAXK];
#pragma unroll
    for (int k = 0; k < MAXK; ++k) {
      const int n = rr + 16 * k;
      sacc[k] = n < N ? st[n * PT + pp] * dlast : 0.f;
    }
    for (int j0 = 0; j0 < len; j0 += TILE) {
      __syncthreads();
      for (int e = tid; e < TILE * N; e += THREADS) {
        const int r = e / N, n = e % N, j = j0 + r;
        tile[r * NS + n] = j < len ? to_f32(bb[(c0 + j) * b_ss + n]) * eout[j] : 0.f;
      }
      __syncthreads();
      const int jn = min(TILE, len - j0);
      for (int jj = 0; jj < jn; ++jj) {
        const float xv = xbar[(j0 + jj) * PT + pp];
#pragma unroll
        for (int k = 0; k < MAXK; ++k) {
          const int n = rr + 16 * k;
          if (n < N) sacc[k] = fmaf(tile[jj * NS + n], xv, sacc[k]);
        }
      }
    }
    __syncthreads();  // every reader of st (the y pass) is done
#pragma unroll
    for (int k = 0; k < MAXK; ++k) {
      const int n = rr + 16 * k;
      if (n < N) st[n * PT + pp] = sacc[k];
    }
  }

  if (state_out != nullptr) {
    __syncthreads();
    for (int e = tid; e < N * PT; e += THREADS) {
      const int n = e / PT, q = e % PT;
      if (p0 + q < P) state_out[((size_t)bh * N + n) * P + p0 + q] = st[e];
    }
  }
}

size_t scan_smem_bytes(int N, int Q) {
  return sizeof(float) * ((size_t)3 * Q + (size_t)Q * PT + (size_t)N * PT +
                          (size_t)TILE * (N + 1) + (size_t)TILE * (TILE + 1));
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* bm, const void* cm, const float* state_in,
                   void* y, float* state_out, float* cb, int B, int S, int H,
                   int G, int N, int P, int Q, long long x_sb, long long x_ss,
                   long long b_sb, long long b_ss, long long c_sb,
                   long long c_ss, cudaStream_t stream) {
  const int nc = (S + Q - 1) / Q;
  const int nt = (Q + TILE - 1) / TILE;
  const dim3 grid1(nt * (nt + 1) / 2, nc, B * G);
  ssd_cb_kernel<T><<<grid1, THREADS, 0, stream>>>(
      static_cast<const T*>(bm), static_cast<const T*>(cm), cb, S, G, N, Q, nc,
      b_sb, b_ss, c_sb, c_ss);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = scan_smem_bytes(N, Q);
  err = cudaFuncSetAttribute(ssd_scan_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid2((P + PT - 1) / PT, B * H);
  ssd_scan_kernel<T><<<grid2, THREADS, smem, stream>>>(
      static_cast<const T*>(x), dt, A, cb, static_cast<const T*>(bm),
      static_cast<const T*>(cm), state_in, static_cast<T*>(y), state_out, S, H,
      G, N, P, Q, nc, x_sb, x_ss, b_sb, b_ss, c_sb, c_ss);
  return cudaGetLastError();
}

}  // namespace

// x [B,S,H,P] and bm, cm [B,S,G,N] (is_bf16: 1 bfloat16, 0 float32), each
// with its last two dims contiguous and the given strides (in elements)
// between batch rows (*_sb) and positions (*_ss); dt [B,S,H] and A [H]
// float32; state_in (or null) and state_out (or null) [B,H,N,P] float32; cb
// a float32 workspace of B * G * ceil(S / Q) * Q * Q; y [B,S,H,P]
// contiguous.  Returns the cudaError_t of the launches (0 on success).
extern "C" int ssd_chunk_fwd(const void* x, const void* dt, const void* A,
                             const void* bm, const void* cm,
                             const void* state_in, void* y, void* state_out,
                             void* cb, int is_bf16, int B, int S, int H, int G,
                             int N, int P, int Q, long long x_sb,
                             long long x_ss, long long b_sb, long long b_ss,
                             long long c_sb, long long c_ss, void* stream) {
  if (B <= 0 || S <= 0 || G <= 0 || H % G != 0 || N <= 0 || N > 16 * MAXK ||
      P <= 0 || Q <= 0 || Q > S)
    return cudaErrorInvalidValue;
  if (scan_smem_bytes(N, Q) > 232448) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A);
  const float* s_in = static_cast<const float*>(state_in);
  float* sout = static_cast<float*>(state_out);
  float* cbf = static_cast<float*>(cb);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, dtf, af, bm, cm, s_in, y, sout, cbf, B, S,
                                 H, G, N, P, Q, x_sb, x_ss, b_sb, b_ss, c_sb,
                                 c_ss, st);
  return launch<float>(x, dtf, af, bm, cm, s_in, y, sout, cbf, B, S, H, G, N, P,
                       Q, x_sb, x_ss, b_sb, b_ss, c_sb, c_ss, st);
}
