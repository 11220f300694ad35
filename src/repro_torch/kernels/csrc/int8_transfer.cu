// Per-row symmetric int8 quantize / dequantize for Hopper (sm_90a): the
// boundary-activation compression of split inference.
//
// Replaces the Pallas TPU kernels src/repro/kernels/int8_transfer.py
// (_quant_kernel / quantize_int8, _dequant_kernel / dequantize_int8).  The
// TPU kernels take 256-row blocks into VMEM; here one block of 256 threads
// owns one row, which gives 512 blocks at the serving shape ([512, 4096]) to
// cover the 132 SMs.  Both kernels are memory-bound (a few operations per
// byte), so the design reads each row from device memory once for the absmax
// and once more (from L2) for the quantize, and writes each output once.
//
// The arithmetic is the reference's, bit for bit:
//   scale = max(absmax, 1e-12) / 127          (IEEE division)
//   q     = clip(rint(x / scale), -127, 127)  (IEEE division; rint rounds
//                                               half to even like jnp.round)
//   x'    = bf16_rn(float(q) * scale)
// so the build must not use --use_fast_math.

#include <stdint.h>

#include "common.cuh"

namespace {

using repro_torch::from_f32;
using repro_torch::to_f32;

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
quantize_rows(const T* __restrict__ x, int8_t* __restrict__ q,
              float* __restrict__ scales, int D) {
  __shared__ float warp_max[THREADS / 32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * D;
  int8_t* qr = q + row * D;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  float amax = 0.f;
  for (int i = threadIdx.x; i < D; i += THREADS) amax = fmaxf(amax, fabsf(to_f32(xr[i])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (lane == 0) warp_max[warp] = amax;
  __syncthreads();
  amax = warp_max[0];
#pragma unroll
  for (int w = 1; w < THREADS / 32; ++w) amax = fmaxf(amax, warp_max[w]);

  const float scale = fmaxf(amax, 1e-12f) / 127.0f;
  for (int i = threadIdx.x; i < D; i += THREADS) {
    const float r = rintf(to_f32(xr[i]) / scale);
    qr[i] = static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
  }
  if (threadIdx.x == 0) scales[row] = scale;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
dequantize_rows(const int8_t* __restrict__ q, const float* __restrict__ scales,
                T* __restrict__ x, int D) {
  const size_t row = blockIdx.x;
  const float scale = scales[row];
  const int8_t* qr = q + row * D;
  T* xr = x + row * D;
  for (int i = threadIdx.x; i < D; i += THREADS)
    xr[i] = from_f32<T>(static_cast<float>(qr[i]) * scale);
}

}  // namespace

// x: [N, D] (is_bf16: 1 bfloat16, 0 float32) -> q int8 [N, D], scales
// float32 [N].  Returns the cudaError_t of the launch.
extern "C" int quantize_int8_fwd(const void* x, void* q, void* scales,
                                 int is_bf16, int N, int D, void* stream) {
  if (N <= 0 || D <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    quantize_rows<__nv_bfloat16><<<N, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(scales), D);
  else
    quantize_rows<float><<<N, THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(scales), D);
  return cudaGetLastError();
}

// q int8 [N, D], scales float32 [N] -> x [N, D] (out_bf16: 1 bfloat16,
// 0 float32).  Returns the cudaError_t of the launch.
extern "C" int dequantize_int8_fwd(const void* q, const void* scales, void* x,
                                   int out_bf16, int N, int D, void* stream) {
  if (N <= 0 || D <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    dequantize_rows<__nv_bfloat16><<<N, THREADS, 0, st>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(scales),
        static_cast<__nv_bfloat16*>(x), D);
  else
    dequantize_rows<float><<<N, THREADS, 0, st>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(scales),
        static_cast<float*>(x), D);
  return cudaGetLastError();
}
