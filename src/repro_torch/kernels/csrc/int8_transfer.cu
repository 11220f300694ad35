// Per-row symmetric int8 quantize / dequantize for Hopper (sm_90a): the
// boundary-activation compression of split inference.
//
// Replaces the Pallas TPU kernels src/repro/kernels/int8_transfer.py
// (_quant_kernel / quantize_int8, _dequant_kernel / dequantize_int8).  The
// TPU kernels take 256-row blocks into VMEM.  Both are memory-bound (a few
// operations per byte), so what counts here is bytes in flight and the
// instructions spent per byte.
//
// Quantize (K2a), fast instance `quantize_rows_vec` (D a multiple of 16
// bytes' worth of elements, 16-byte-aligned rows, at most 2,048 vectors a
// row: bf16 D <= 16,384, float32 D <= 8,192): each row belongs to a group of
// four warps, two rows to a 256-thread block, and each lane loads its
// NV <= 16 vectors of 16 bytes (ld.global.nc, no L1 allocation; NV is a
// template on the width) before anything else, so the row is read from
// device memory once and stays in registers.  The absmax is a max over the
// magnitude bits (bf16 pairs as u16x2), reduced by a warp `redux` and, across
// the row's four warps, through a word of shared memory each and a named
// barrier of those warps alone.  Each lane then packs the 8 (bf16) or 4
// (float32) codes of one vector into one 8- or 4-byte store.  On the card,
// four warps a row beat one or two at every width timed (2,048 to 4,096:
// more warps in flight an SM for the same bytes).  Other widths and
// unaligned rows take the general instance `quantize_rows`: one block of 256
// threads a row, reading it twice (absmax, then quotient).
//
// Two more modes of both instances serve a row that several ranks hold
// pieces of (gradient compression on a tensor-parallel mesh): kAbsmax
// writes each row's absmax (float32) and nothing else, and kGiven takes the
// row's absmax from a buffer (the ranks' absmaxes reduced by MAX) instead of
// reducing its own, then quantizes as kQuant does.  A row's codes and scale
// depend only on its absmax and its elements, so the pieces' codes and
// scales are the whole row's, bit for bit.
//
// The arithmetic is the reference's, bit for bit:
//   scale = max(absmax, 1e-12) / 127          (IEEE division, once a row)
//   q     = clip(rint(x / scale), -127, 127)  (rint rounds half to even,
//                                               like jnp.round)
//   x'    = bf16_rn(float(q) * scale)
// For bf16 input the per-element quotient is not a division: with
// r = rcp_rn(scale), y = x*r, e = fma(-y, scale, x) (the exact remainder)
// and y' = fma(e, r, y) equal x / scale rounded to nearest (Markstein's
// correction).  That this holds for every finite bf16 x and every bf16
// absmax is checked exhaustively on the card (tests/test_torch_kernels_cuda.py,
// chip_smoke.py) and by an exact emulation on the CPU
// (tests/test_torch_int8_domain.py).  Float32 input keeps the IEEE division
// per element: its domain cannot be swept.  Rounding adds 1.5 * 2^23 to the
// clipped quotient, which leaves the nearest integer, ties to even, in the
// low byte of the sum's bits.  The build must not use --use_fast_math
// (flush-to-zero would change subnormal inputs); the divisions and products
// that must round as IEEE are written with the _rn intrinsics.

#include <stdint.h>

#include "common.cuh"

namespace {

using repro_torch::from_f32;
using repro_torch::to_f32;

constexpr int THREADS = 256;   // general quantize and dequantize: a block a row
constexpr int ROW_WARPS = 4;   // the fast instance: four warps a row
constexpr int ROW_THREADS = 32 * ROW_WARPS;
constexpr int VEC_ROWS = 2;    // two rows a block
constexpr int MAX_VEC = 2048;  // 16-byte vectors a row on the fast path
constexpr float ROUNDER = 12582912.0f;  // 1.5 * 2^23

// kQuant: absmax, scale, codes; kAbsmax: the absmax alone (into `scales`);
// kGiven: scale and codes from the absmax in `given`
enum Mode { kQuant = 0, kAbsmax = 1, kGiven = 2 };

__device__ __forceinline__ float row_scale(float amax) {
  return __fdiv_rn(fmaxf(amax, 1e-12f), 127.0f);
}

// x / scale rounded to nearest: IEEE division for float32, the corrected
// reciprocal product for bf16 (see the header)
template <typename T>
__device__ __forceinline__ float quotient(float x, float scale, float r);

template <>
__device__ __forceinline__ float quotient<float>(float x, float scale, float) {
  return __fdiv_rn(x, scale);
}

template <>
__device__ __forceinline__ float quotient<__nv_bfloat16>(float x, float scale,
                                                         float r) {
  const float y = __fmul_rn(x, r);
  const float e = __fmaf_rn(-y, scale, x);
  return __fmaf_rn(e, r, y);
}

// clip(rint(y), -127, 127) in the low byte of the result
__device__ __forceinline__ uint32_t code(float y) {
  return __float_as_uint(__fadd_rn(fminf(fmaxf(y, -127.f), 127.f), ROUNDER));
}

// the low bytes of four codes, packed in order
__device__ __forceinline__ uint32_t pack4(uint32_t c0, uint32_t c1, uint32_t c2,
                                          uint32_t c3) {
  return __byte_perm(__byte_perm(c0, c1, 0x0040), __byte_perm(c2, c3, 0x0040),
                     0x5410);
}

__device__ __forceinline__ uint4 load_once(const uint4* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t max_u16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.u16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ void row_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// One 16-byte vector of each storage type: its magnitude max (as the bits of
// a non-negative float, whose order is the unsigned order) and its codes.
template <typename T>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kElems = 8;
  // u16x2 max of the bf16 magnitudes; fold() turns it into float bits
  static __device__ __forceinline__ uint32_t max_mag(uint32_t acc, uint4 v) {
    acc = max_u16x2(acc, v.x & 0x7fff7fffu);
    acc = max_u16x2(acc, v.y & 0x7fff7fffu);
    acc = max_u16x2(acc, v.z & 0x7fff7fffu);
    return max_u16x2(acc, v.w & 0x7fff7fffu);
  }
  static __device__ __forceinline__ uint32_t fold(uint32_t acc) {
    return max(acc & 0xffffu, acc >> 16) << 16;
  }
  static __device__ __forceinline__ void store(int8_t* dst, uint4 v, float scale, float r) {
    const auto lo = [&](uint32_t w) {  // element 2k: the low half
      return code(quotient<__nv_bfloat16>(__uint_as_float(w << 16), scale, r));
    };
    const auto hi = [&](uint32_t w) {
      return code(quotient<__nv_bfloat16>(__uint_as_float(w & 0xffff0000u), scale, r));
    };
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(pack4(lo(v.x), hi(v.x), lo(v.y), hi(v.y)),
                   pack4(lo(v.z), hi(v.z), lo(v.w), hi(v.w)));
  }
};

template <>
struct Vec<float> {
  static constexpr int kElems = 4;
  static __device__ __forceinline__ uint32_t max_mag(uint32_t acc, uint4 v) {
    acc = max(acc, v.x & 0x7fffffffu);
    acc = max(acc, v.y & 0x7fffffffu);
    acc = max(acc, v.z & 0x7fffffffu);
    return max(acc, v.w & 0x7fffffffu);
  }
  static __device__ __forceinline__ uint32_t fold(uint32_t acc) { return acc; }
  static __device__ __forceinline__ void store(int8_t* dst, uint4 v, float scale, float r) {
    const auto c = [&](uint32_t w) {
      return code(quotient<float>(__uint_as_float(w), scale, r));
    };
    *reinterpret_cast<uint32_t*>(dst) = pack4(c(v.x), c(v.y), c(v.z), c(v.w));
  }
};

// K2a, fast instance: NV vectors a lane; the row's vectors past D / kElems
// are masked.
template <typename T, int NV, int M>
__global__ void __launch_bounds__(VEC_ROWS * ROW_THREADS)
quantize_rows_vec(const T* __restrict__ x, int8_t* __restrict__ q,
                  float* __restrict__ scales, const float* __restrict__ given,
                  int N, int D) {
  using V = Vec<T>;
  __shared__ uint32_t warp_max[VEC_ROWS * ROW_WARPS];
  const int group = threadIdx.x / ROW_THREADS, t = threadIdx.x % ROW_THREADS;
  const size_t row = size_t(blockIdx.x) * VEC_ROWS + group;
  if (row >= size_t(N)) return;  // the row's warps leave together
  const int nvec = D / V::kElems;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * D);

  uint4 v[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = j * ROW_THREADS + t;
    v[j] = i < nvec ? load_once(xr + i) : make_uint4(0u, 0u, 0u, 0u);
  }
  float amax;
  if constexpr (M == kGiven) {
    amax = given[row];
  } else {
    uint32_t mag = 0;
#pragma unroll
    for (int j = 0; j < NV; ++j) mag = V::max_mag(mag, v[j]);
    mag = __reduce_max_sync(0xffffffffu, V::fold(mag));
    if (t % 32 == 0) warp_max[threadIdx.x / 32] = mag;
    row_barrier(1 + group, ROW_THREADS);
#pragma unroll
    for (int w = 0; w < ROW_WARPS; ++w) mag = max(mag, warp_max[group * ROW_WARPS + w]);
    amax = __uint_as_float(mag);
  }
  if constexpr (M == kAbsmax) {
    if (t == 0) scales[row] = amax;
    return;
  }
  const float scale = row_scale(amax);
  const float r = __frcp_rn(scale);

  int8_t* qr = q + row * D;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = j * ROW_THREADS + t;
    if (i < nvec) V::store(qr + size_t(i) * V::kElems, v[j], scale, r);
  }
  if (t == 0) scales[row] = scale;
}

// K2a, general instance: one block a row, any D, any alignment.
template <typename T, int M>
__global__ void __launch_bounds__(THREADS)
quantize_rows(const T* __restrict__ x, int8_t* __restrict__ q,
              float* __restrict__ scales, const float* __restrict__ given, int D) {
  __shared__ float warp_max[THREADS / 32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * D;
  int8_t* qr = q + row * D;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  float amax = 0.f;
  if constexpr (M == kGiven) {
    amax = given[row];
  } else {
    for (int i = threadIdx.x; i < D; i += THREADS) amax = fmaxf(amax, fabsf(to_f32(xr[i])));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    if (lane == 0) warp_max[warp] = amax;
    __syncthreads();
    amax = warp_max[0];
#pragma unroll
    for (int w = 1; w < THREADS / 32; ++w) amax = fmaxf(amax, warp_max[w]);
  }
  if constexpr (M == kAbsmax) {
    if (threadIdx.x == 0) scales[row] = amax;
    return;
  }

  const float scale = row_scale(amax);
  const float r = __frcp_rn(scale);
  for (int i = threadIdx.x; i < D; i += THREADS)
    qr[i] = static_cast<int8_t>(code(quotient<T>(to_f32(xr[i]), scale, r)) & 0xffu);
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

template <typename T, int NV, int M>
void launch_vec(const T* x, int8_t* q, float* scales, const float* given, int N,
                int D, cudaStream_t st) {
  quantize_rows_vec<T, NV, M><<<(N + VEC_ROWS - 1) / VEC_ROWS,
                                VEC_ROWS * ROW_THREADS, 0, st>>>(x, q, scales,
                                                                 given, N, D);
}

template <typename T, int M>
void launch_quantize(const T* x, int8_t* q, float* scales, const float* given,
                     int N, int D, cudaStream_t st) {
  constexpr int E = Vec<T>::kElems;
  const int nvec = D / E;
  if (D % E != 0 || nvec > MAX_VEC || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(q) % 8 != 0) {
    quantize_rows<T, M><<<N, THREADS, 0, st>>>(x, q, scales, given, D);
  } else if (nvec <= ROW_THREADS) {  // bf16 D <= 1,024
    launch_vec<T, 1, M>(x, q, scales, given, N, D, st);
  } else if (nvec <= 2 * ROW_THREADS) {  // D <= 2,048
    launch_vec<T, 2, M>(x, q, scales, given, N, D, st);
  } else if (nvec <= 4 * ROW_THREADS) {  // D <= 4,096
    launch_vec<T, 4, M>(x, q, scales, given, N, D, st);
  } else if (nvec <= 8 * ROW_THREADS) {  // D <= 8,192
    launch_vec<T, 8, M>(x, q, scales, given, N, D, st);
  } else {  // D <= 16,384
    launch_vec<T, 16, M>(x, q, scales, given, N, D, st);
  }
}

template <int M>
int quantize_any(const void* x, void* q, void* scales, const void* given,
                 int is_bf16, int N, int D, void* stream) {
  if (N <= 0 || D <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    launch_quantize<__nv_bfloat16, M>(static_cast<const __nv_bfloat16*>(x),
                                      static_cast<int8_t*>(q),
                                      static_cast<float*>(scales),
                                      static_cast<const float*>(given), N, D, st);
  else
    launch_quantize<float, M>(static_cast<const float*>(x), static_cast<int8_t*>(q),
                              static_cast<float*>(scales),
                              static_cast<const float*>(given), N, D, st);
  return cudaGetLastError();
}

}  // namespace

// x: [N, D] (is_bf16: 1 bfloat16, 0 float32) -> q int8 [N, D], scales
// float32 [N].  Returns the cudaError_t of the launch.
extern "C" int quantize_int8_fwd(const void* x, void* q, void* scales,
                                 int is_bf16, int N, int D, void* stream) {
  return quantize_any<kQuant>(x, q, scales, nullptr, is_bf16, N, D, stream);
}

// x: [N, D] -> amax float32 [N]: each row's absmax (K2a's first pass alone).
extern "C" int row_absmax_fwd(const void* x, void* amax, int is_bf16, int N, int D,
                              void* stream) {
  return quantize_any<kAbsmax>(x, nullptr, amax, nullptr, is_bf16, N, D, stream);
}

// x: [N, D], amax float32 [N] (each row's absmax, reduced over the rows'
// pieces) -> q int8 [N, D], scales float32 [N].
extern "C" int quantize_int8_given_fwd(const void* x, const void* amax, void* q,
                                       void* scales, int is_bf16, int N, int D,
                                       void* stream) {
  return quantize_any<kGiven>(x, q, scales, amax, is_bf16, N, D, stream);
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
