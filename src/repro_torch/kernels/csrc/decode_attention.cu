// Split-KV GQA decode attention for Hopper (sm_90a): one new query token per
// sequence against a KV cache, masked to cur_len, with an optional sliding
// window and tanh soft-cap (flash-decoding).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (_decode_kernel, called by decode_attention).  The TPU grid (B, nk) walks
// the cache blocks of one sequence in order and carries (m, l, acc) in VMEM
// scratch; a grid of B x KV blocks would leave most of the 132 SMs idle, so
// here the cache axis is cut into n_split chunks that run in parallel:
//
//   decode_split_kernel   grid (n_split, KV * G / GB, B), 128 threads.  One
//                         block takes GB query heads of one KV head and one
//                         chunk of the cache, and writes its partial
//                         (m, l, acc[GB][HD]) in float32 to a workspace.
//   decode_combine_kernel grid (B * H), HD threads: rescales the partials of
//                         every chunk to their common max and divides.
//
// What bounds it: bytes.  Each cache entry is read once and takes G = H / KV
// FMAs per element (4 for Llama-3-8B): ~2 FLOP per byte, far under what the
// CUDA cores sustain, so the kernel uses plain float32 FMAs, no tensor cores.
// Every thread loads 16 bytes of one key row and of one value row at a time;
// HD / (16 / sizeof(T)) neighbouring lanes cover one row, so a warp reads
// whole rows, and UNROLL rows per lane group are in flight before any math.
// Chunks past cur_len, or before the window, exit without loading anything.
//
// cur_len is read on the device, as one int32 or one per row, so a decode
// step needs no host sync for it.  Arithmetic is the TPU kernel's: q scaled
// in float32, scores, softmax and P.V in float32, output acc / max(l, 1e-30)
// in q's dtype.  Masked keys are skipped, which equals the kernel's
// exp(-2e38 - m) = 0 for every chunk that holds a valid key.

#include <stdint.h>

#include "common.cuh"

namespace {

using repro_torch::from_f32;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -2.0e38f;  // the Pallas kernel's mask value

// 16 bytes of storage type T, widened to float32.
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const uint4& r, float* out) {
    out[0] = __uint_as_float(r.x);
    out[1] = __uint_as_float(r.y);
    out[2] = __uint_as_float(r.z);
    out[3] = __uint_as_float(r.w);
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  // a bfloat16 is the high half of a float32: widening is a shift (exact);
  // element 2i sits in the low half of word i (little endian)
  static __device__ __forceinline__ void unpack(const uint4& r, float* out) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <typename T>
__device__ __forceinline__ uint4 load16(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// Workspace layout: ws_ml [B, H, n_split, 2] holds (m, l), ws_acc
// [B, H, n_split, HD] the unnormalised output of each chunk.  l == 0 marks a
// chunk with no valid key.
template <typename T, int HD, int GB>
__global__ void __launch_bounds__(THREADS)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ cur_len,
                    int cur_per_row, float* __restrict__ ws_ml,
                    float* __restrict__ ws_acc, int S, int H, int KV,
                    int chunk, int window, float logit_cap, float scale) {
  constexpr int VEC = Pack<T>::N;        // elements per 16-byte load
  constexpr int TPK = HD / VEC;          // lanes that share one key row
  static_assert(TPK >= 1 && TPK <= 32 && 32 % TPK == 0, "unsupported head dim");
  constexpr int KPW = 32 / TPK;          // key rows a warp reads at once
  constexpr int NG = WARPS * KPW;        // lane groups in the block
  constexpr int UNROLL = GB * VEC >= 64 ? 2 : 4;  // rows in flight per group
  constexpr int STEP = NG * UNROLL;      // keys the block takes per iteration

  __shared__ float sm_m[NG][GB];
  __shared__ float sm_l[NG][GB];
  __shared__ float sm_acc[NG][GB][HD];

  const int n_split = gridDim.x;
  const int split = blockIdx.x;
  const int G = H / KV;
  const int per_kv = G / GB;
  const int kvh = blockIdx.y / per_kv;
  const int h0 = kvh * G + (blockIdx.y % per_kv) * GB;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int t = lane % TPK;              // this lane's HD slice: [t*VEC, t*VEC+VEC)
  const int grp = (tid / 32) * KPW + lane / TPK;

  // valid keys: k_pos < cur and, with a window, k_pos > cur - 1 - window
  const int cur = min(cur_len[cur_per_row ? b : 0], S);
  int lo = split * chunk;
  const int hi = min(min(lo + chunk, S), cur);
  if (window > 0) lo = max(lo, cur - window);

  const size_t row0 = ((size_t)b * H + h0) * n_split + split;
  if (lo >= hi) {  // nothing valid in this chunk: load nothing
    if (tid < GB) {
      const size_t row = row0 + (size_t)tid * n_split;
      ws_ml[2 * row] = NEG_INF;
      ws_ml[2 * row + 1] = 0.f;
    }
    return;
  }

  float qv[GB][VEC];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    Pack<T>::unpack(load16(q + ((size_t)b * H + h0 + g) * HD + t * VEC), qv[g]);
#pragma unroll
    for (int i = 0; i < VEC; ++i) qv[g][i] *= scale;
  }

  float m[GB], l[GB], acc[GB][VEC];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[g][i] = 0.f;
  }

  const size_t pos_stride = (size_t)KV * HD;  // elements between positions
  const T* kb = k + ((size_t)b * S * KV + kvh) * HD + t * VEC;
  const T* vb = v + ((size_t)b * S * KV + kvh) * HD + t * VEC;

  // the loop bound is block-uniform, so every lane reaches the shuffles
  for (int base = lo; base < hi; base += STEP) {
    uint4 kr[UNROLL], vr[UNROLL];
    bool ok[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int s = base + u * NG + grp;
      ok[u] = s < hi;
      if (ok[u]) {
        kr[u] = load16(kb + s * pos_stride);
        vr[u] = load16(vb + s * pos_stride);
      } else {
        kr[u] = make_uint4(0u, 0u, 0u, 0u);
        vr[u] = kr[u];
      }
    }

    float sc[UNROLL][GB];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float kf[VEC];
      Pack<T>::unpack(kr[u], kf);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) dot = fmaf(qv[g][i], kf[i], dot);
        sc[u][g] = dot;
      }
    }
    // sum the partial dot products over the TPK lanes of each key row
#pragma unroll
    for (int off = TPK / 2; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int g = 0; g < GB; ++g)
          sc[u][g] += __shfl_xor_sync(0xffffffffu, sc[u][g], off);

    // online softmax over this group's UNROLL keys: one rescale per tile
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float tmax = NEG_INF;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (ok[u]) {
          float s = sc[u][g];
          if (logit_cap > 0.f) s = logit_cap * tanhf(s / logit_cap);
          sc[u][g] = s;
          tmax = fmaxf(tmax, s);
        }
      }
      const float m_new = fmaxf(m[g], tmax);
      const float corr = expf(m[g] - m_new);
      m[g] = m_new;
      l[g] *= corr;
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[g][i] *= corr;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        sc[u][g] = ok[u] ? expf(sc[u][g] - m_new) : 0.f;
        l[g] += sc[u][g];
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (!ok[u]) continue;
      float vf[VEC];
      Pack<T>::unpack(vr[u], vf);
#pragma unroll
      for (int g = 0; g < GB; ++g)
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[g][i] = fmaf(sc[u][g], vf[i], acc[g][i]);
    }
  }

  // fold the NG lane groups of the block into one partial per head
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    if (t == 0) {
      sm_m[grp][g] = m[g];
      sm_l[grp][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) sm_acc[grp][g][t * VEC + i] = acc[g][i];
  }
  __syncthreads();
  for (int idx = tid; idx < GB * HD; idx += THREADS) {
    const int g = idx / HD;
    const int d = idx % HD;
    float mx = NEG_INF;
    for (int r = 0; r < NG; ++r)
      if (sm_l[r][g] > 0.f) mx = fmaxf(mx, sm_m[r][g]);
    float ls = 0.f, as = 0.f;
    for (int r = 0; r < NG; ++r) {
      if (sm_l[r][g] > 0.f) {
        const float w = expf(sm_m[r][g] - mx);
        ls = fmaf(sm_l[r][g], w, ls);
        as = fmaf(sm_acc[r][g][d], w, as);
      }
    }
    const size_t row = row0 + (size_t)g * n_split;
    ws_acc[row * HD + d] = as;
    if (d == 0) {
      ws_ml[2 * row] = mx;
      ws_ml[2 * row + 1] = ls;
    }
  }
}

template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ ws_ml,
                                      const float* __restrict__ ws_acc,
                                      T* __restrict__ o, int n_split, int HD) {
  const size_t bh = blockIdx.x;
  const float* ml = ws_ml + bh * n_split * 2;
  const float* ac = ws_acc + bh * n_split * HD;
  for (int d = threadIdx.x; d < HD; d += blockDim.x) {
    float mx = NEG_INF;
    for (int s = 0; s < n_split; ++s)
      if (ml[2 * s + 1] > 0.f) mx = fmaxf(mx, ml[2 * s]);
    float ls = 0.f, as = 0.f;
    for (int s = 0; s < n_split; ++s) {
      if (ml[2 * s + 1] > 0.f) {
        const float w = expf(ml[2 * s] - mx);
        ls = fmaf(ml[2 * s + 1], w, ls);
        as = fmaf(ac[(size_t)s * HD + d], w, as);
      }
    }
    o[bh * HD + d] = from_f32<T>(as / fmaxf(ls, 1e-30f));
  }
}

template <typename T, int HD, int GB>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* cur_len, int cur_per_row, void* o, float* ws_ml,
                   float* ws_acc, int B, int S, int H, int KV, int n_split,
                   int chunk, int window, float logit_cap, float scale,
                   cudaStream_t stream) {
  const dim3 grid(n_split, H / GB, B);
  decode_split_kernel<T, HD, GB><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), cur_len, cur_per_row, ws_ml, ws_acc, S, H, KV,
      chunk, window, logit_cap, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T><<<B * H, HD, 0, stream>>>(
      ws_ml, ws_acc, static_cast<T*>(o), n_split, HD);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dispatch_gb(int GB, const void* q, const void* k, const void* v,
                        const int* cur_len, int cur_per_row, void* o,
                        float* ws_ml, float* ws_acc, int B, int S, int H,
                        int KV, int n_split, int chunk, int window,
                        float logit_cap, float scale, cudaStream_t stream) {
#define REPRO_DECODE_LAUNCH(gb)                                              \
  return launch<T, HD, gb>(q, k, v, cur_len, cur_per_row, o, ws_ml, ws_acc, \
                           B, S, H, KV, n_split, chunk, window, logit_cap,  \
                           scale, stream)
  switch (GB) {
    case 8: REPRO_DECODE_LAUNCH(8);
    case 4: REPRO_DECODE_LAUNCH(4);
    case 2: REPRO_DECODE_LAUNCH(2);
    case 1: REPRO_DECODE_LAUNCH(1);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_DECODE_LAUNCH
}

template <typename T>
cudaError_t dispatch_hd(int HD, int GB, const void* q, const void* k,
                        const void* v, const int* cur_len, int cur_per_row,
                        void* o, float* ws_ml, float* ws_acc, int B, int S,
                        int H, int KV, int n_split, int chunk, int window,
                        float logit_cap, float scale, cudaStream_t stream) {
#define REPRO_DECODE_HD(hd)                                                  \
  return dispatch_gb<T, hd>(GB, q, k, v, cur_len, cur_per_row, o, ws_ml,    \
                            ws_acc, B, S, H, KV, n_split, chunk, window,    \
                            logit_cap, scale, stream)
  switch (HD) {
    case 16: REPRO_DECODE_HD(16);
    case 32: REPRO_DECODE_HD(32);
    case 64: REPRO_DECODE_HD(64);
    case 128: REPRO_DECODE_HD(128);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_DECODE_HD
}

}  // namespace

// Returns the cudaError_t of the launches (0 on success).  q/o are
// contiguous [B, H, HD], k/v contiguous [B, S, KV, HD], all of the storage
// type is_bf16 selects (1 bfloat16, 0 float32); cur_len is int32, one value
// (cur_per_row 0) or B values (1), on the device.  ws_ml holds
// B * H * n_split * 2 floats, ws_acc B * H * n_split * HD; chunk * n_split
// must cover S.  GB, the query heads a block takes, is the largest of
// 8, 4, 2, 1 that divides H / KV.
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* cur_len, int cur_per_row,
                                    void* o, void* ws_ml, void* ws_acc,
                                    int is_bf16, int B, int S, int H, int KV,
                                    int HD, int n_split, int chunk, int window,
                                    float logit_cap, float scale, void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || n_split <= 0 ||
      chunk <= 0 || (long long)chunk * n_split < S)
    return cudaErrorInvalidValue;
  const int G = H / KV;
  const int GB = G % 8 == 0 ? 8 : G % 4 == 0 ? 4 : G % 2 == 0 ? 2 : 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* cl = static_cast<const int*>(cur_len);
  float* ml = static_cast<float*>(ws_ml);
  float* ac = static_cast<float*>(ws_acc);
  if (is_bf16)
    return dispatch_hd<__nv_bfloat16>(HD, GB, q, k, v, cl, cur_per_row, o, ml,
                                      ac, B, S, H, KV, n_split, chunk, window,
                                      logit_cap, scale, st);
  return dispatch_hd<float>(HD, GB, q, k, v, cl, cur_per_row, o, ml, ac, B, S,
                            H, KV, n_split, chunk, window, logit_cap, scale, st);
}
