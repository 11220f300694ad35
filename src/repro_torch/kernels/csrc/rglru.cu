// RG-LRU linear recurrence for Hopper (sm_90a): h_t = a_t * h_{t-1} + x_t
// over [B, S, W], float32 carry, parallel over B x W.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru.py (_rglru_kernel,
// called by rglru_scan).  The TPU kernel walks S as its sequential minor
// grid axis with h in VMEM scratch, starting from zero; the model path
// (src/repro/models/griffin.py::rglru) also starts from a carried h0, which
// this kernel takes directly.
//
// What bounds it on the H100: bytes (2 multiply-adds per 12 bytes in
// float32).  At the Griffin prefill shape (B=1, S=512, W=4096) one thread per
// lane walking all of S would be 4,096 threads, one warp per SM, each step
// waiting on its loads.  So S is cut into chunks of 64 steps, a thread per
// (lane, chunk) -- 32,768 threads -- and the recurrence runs in two passes:
//  1. rglru_chunk_kernel: each chunk from h = 0, writing the chunk's product
//     of a and its local end state (skipped when S fits one chunk);
//  2. rglru_apply_kernel: each thread folds the earlier chunks' (product,
//     end state) pairs into its carry-in, h0 first, then walks its chunk
//     again from that carry, writing h.
// Within a chunk the recurrence runs in the oracle's order; only the carry
// into a chunk is reassociated, (prod a) h + h_local, a few float32 ulps.
// Each thread loads 16 steps of a and x before it uses any, so loads run
// ahead of the dependent chain.  Consecutive threads own consecutive lanes:
// every load and store of a warp is one 128-byte line (float32).  Traffic is
// a and x twice and h once: 42 MB at the prefill shape against the 25 MB
// the function must move.

#include <stdint.h>

#include "common.cuh"

namespace {

using repro_torch::from_f32;
using repro_torch::to_f32;

constexpr int THREADS = 128;
constexpr int CHUNK = 64;    // steps of S per thread
constexpr int UNROLL = 16;   // steps loaded before the recurrence uses them

template <typename T>
__global__ void __launch_bounds__(THREADS)
rglru_chunk_kernel(const T* __restrict__ a, const T* __restrict__ x,
                   float* __restrict__ aprod, float* __restrict__ hloc, int S,
                   int W, int nc) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  const int c = blockIdx.y, b = blockIdx.z;
  if (w >= W) return;
  const int s0 = c * CHUNK, s1 = min(S, s0 + CHUNK);
  const size_t base = (size_t)b * S * W + w;
  float h = 0.f, p = 1.f;
  for (int t0 = s0; t0 < s1; t0 += UNROLL) {
    float av[UNROLL], xv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = t0 + u;
      av[u] = t < s1 ? to_f32(a[base + (size_t)t * W]) : 1.f;
      xv[u] = t < s1 ? to_f32(x[base + (size_t)t * W]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      h = av[u] * h + xv[u];
      p *= av[u];
    }
  }
  const size_t o = ((size_t)b * nc + c) * W + w;
  aprod[o] = p;
  hloc[o] = h;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rglru_apply_kernel(const T* __restrict__ a, const T* __restrict__ x,
                   const float* __restrict__ h0, const float* __restrict__ aprod,
                   const float* __restrict__ hloc, T* __restrict__ out, int S,
                   int W, int nc) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  const int c = blockIdx.y, b = blockIdx.z;
  if (w >= W) return;
  float h = h0 != nullptr ? h0[(size_t)b * W + w] : 0.f;
  for (int k = 0; k < c; ++k) {
    const size_t o = ((size_t)b * nc + k) * W + w;
    h = aprod[o] * h + hloc[o];
  }
  const int s0 = c * CHUNK, s1 = min(S, s0 + CHUNK);
  const size_t base = (size_t)b * S * W + w;
  for (int t0 = s0; t0 < s1; t0 += UNROLL) {
    float av[UNROLL], xv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = t0 + u;
      av[u] = t < s1 ? to_f32(a[base + (size_t)t * W]) : 1.f;
      xv[u] = t < s1 ? to_f32(x[base + (size_t)t * W]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = t0 + u;
      h = av[u] * h + xv[u];
      if (t < s1) out[base + (size_t)t * W] = from_f32<T>(h);
    }
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* x, const float* h0, float* ws,
                   void* out, int B, int S, int W, cudaStream_t stream) {
  const int nc = (S + CHUNK - 1) / CHUNK;
  const dim3 grid((W + THREADS - 1) / THREADS, nc, B);
  float* aprod = ws;
  float* hloc = ws + (size_t)B * nc * W;
  if (nc > 1) {
    rglru_chunk_kernel<T><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(x), aprod, hloc, S, W, nc);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  rglru_apply_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(x), h0, aprod, hloc,
      static_cast<T*>(out), S, W, nc);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The backward (training): the VJP of the recurrence, float32.  It replaces
// no TPU kernel (the reference differentiates models/griffin.py::rglru, an
// associative scan).  With g_t = dy_t + a_{t+1} g_{t+1} (g past the end 0):
// dx_t = g_t, da_t = g_t h_{t-1} (h_{-1} = h0 or 0), dh0 = a_0 g_0.  A
// thread carries c = a_t g_t down its chunk, so g_t = dy_t + c of the step
// after.  What bounds it: bytes (dy, a, h read, dx, da written: 84 MB at
// Griffin's training shape, 25 us).  The forward's two passes, reversed:
//  1. rglru_bwd_chunk_kernel: each chunk from c = 0 at its end, writing the
//     chunk's product of a and its local a_{s0} g_{s0} (skipped when S fits
//     one chunk);
//  2. rglru_bwd_apply_kernel: each thread folds the later chunks' (product,
//     local carry) pairs into its carry-in, the last chunk first, then walks
//     its chunk again from that carry, writing dx and da; chunk 0 writes
//     dh0.  h_{t-1} is read from the forward's float32 output.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
rglru_bwd_chunk_kernel(const float* __restrict__ a, const float* __restrict__ dy,
                       float* __restrict__ aprod, float* __restrict__ cloc,
                       int S, int W, int nc) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  const int c = blockIdx.y, b = blockIdx.z;
  if (w >= W) return;
  const int s0 = c * CHUNK, s1 = min(S, s0 + CHUNK);
  const size_t base = (size_t)b * S * W + w;
  float carry = 0.f, p = 1.f;
  for (int t0 = s1 - 1; t0 >= s0; t0 -= UNROLL) {
    float av[UNROLL], dv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = t0 - u;
      av[u] = t >= s0 ? a[base + (size_t)t * W] : 1.f;
      dv[u] = t >= s0 ? dy[base + (size_t)t * W] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (t0 - u < s0) break;
      carry = av[u] * (dv[u] + carry);
      p *= av[u];
    }
  }
  const size_t o = ((size_t)b * nc + c) * W + w;
  aprod[o] = p;
  cloc[o] = carry;
}

__global__ void __launch_bounds__(THREADS)
rglru_bwd_apply_kernel(const float* __restrict__ a, const float* __restrict__ h,
                       const float* __restrict__ dy, const float* __restrict__ h0,
                       const float* __restrict__ aprod,
                       const float* __restrict__ cloc, float* __restrict__ da,
                       float* __restrict__ dx, float* __restrict__ dh0, int S,
                       int W, int nc) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  const int c = blockIdx.y, b = blockIdx.z;
  if (w >= W) return;
  float carry = 0.f;
  for (int k = nc - 1; k > c; --k) {
    const size_t o = ((size_t)b * nc + k) * W + w;
    carry = aprod[o] * carry + cloc[o];
  }
  const int s0 = c * CHUNK, s1 = min(S, s0 + CHUNK);
  const size_t base = (size_t)b * S * W + w;
  const float hfirst = h0 != nullptr ? h0[(size_t)b * W + w] : 0.f;
  for (int t0 = s1 - 1; t0 >= s0; t0 -= UNROLL) {
    float av[UNROLL], dv[UNROLL], hv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = t0 - u;
      av[u] = t >= s0 ? a[base + (size_t)t * W] : 1.f;
      dv[u] = t >= s0 ? dy[base + (size_t)t * W] : 0.f;
      hv[u] = t > 0 && t >= s0 ? h[base + (size_t)(t - 1) * W] : hfirst;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = t0 - u;
      if (t < s0) break;
      const float g = dv[u] + carry;
      dx[base + (size_t)t * W] = g;
      da[base + (size_t)t * W] = g * hv[u];
      carry = av[u] * g;
    }
  }
  if (c == 0 && dh0 != nullptr) dh0[(size_t)b * W + w] = carry;
}

}  // namespace

// Steps of S each thread walks; the wrapper sizes the workspace with it.
extern "C" int rglru_chunk_steps() { return CHUNK; }

// a, x, out [B, S, W] contiguous (is_bf16: 1 bfloat16, 0 float32); h0 [B, W]
// float32 or null (zero); ws a float32 workspace of 2 * B * ceil(S / CHUNK)
// * W.  Returns the cudaError_t of the launches (0 on success).
extern "C" int rglru_fwd(const void* a, const void* x, const void* h0,
                         void* ws, void* out, int is_bf16, int B, int S, int W,
                         void* stream) {
  if (B <= 0 || S <= 0 || W <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* h0f = static_cast<const float*>(h0);
  float* wsf = static_cast<float*>(ws);
  if (is_bf16) return launch<__nv_bfloat16>(a, x, h0f, wsf, out, B, S, W, st);
  return launch<float>(a, x, h0f, wsf, out, B, S, W, st);
}

// The backward: a, h (the forward's float32 output), dy, da, dx [B, S, W]
// contiguous float32; h0 and dh0 [B, W] float32 or null (no h0: zero, and
// no dh0); ws a float32 workspace of 2 * B * ceil(S / CHUNK) * W.  Returns
// the cudaError_t of the launches (0 on success).
extern "C" int rglru_bwd(const void* a, const void* h, const void* dy,
                         const void* h0, void* ws, void* da, void* dx,
                         void* dh0, int B, int S, int W, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nc = (S + CHUNK - 1) / CHUNK;
  const dim3 grid((W + THREADS - 1) / THREADS, nc, B);
  float* aprod = static_cast<float*>(ws);
  float* cloc = aprod + (size_t)B * nc * W;
  const float* af = static_cast<const float*>(a);
  const float* dyf = static_cast<const float*>(dy);
  if (nc > 1) {
    rglru_bwd_chunk_kernel<<<grid, THREADS, 0, st>>>(af, dyf, aprod, cloc, S, W, nc);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  rglru_bwd_apply_kernel<<<grid, THREADS, 0, st>>>(
      af, static_cast<const float*>(h), dyf, static_cast<const float*>(h0), aprod,
      cloc, static_cast<float*>(da), static_cast<float*>(dx),
      static_cast<float*>(dh0), S, W, nc);
  return cudaGetLastError();
}
