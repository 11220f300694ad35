// Split-KV GQA decode attention for Hopper (sm_90a): one new query token per
// sequence against a KV cache, masked to cur_len, with an optional sliding
// window and tanh soft-cap (flash-decoding), in one launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (_decode_kernel, called by decode_attention).  The TPU grid (B, nk) walks
// the cache blocks of one sequence in order and carries (m, l, acc) in VMEM
// scratch; a grid of B x KV blocks would leave most of the 132 SMs idle, so
// here the cache axis is cut into n_split chunks that run in parallel.  Grid
// (n_split, H / GB, B), 256 threads: one block takes GB query heads of one
// KV head and one chunk of the cache.
//
// What bounds it: on paper bytes.  Each cache entry is read once and takes
// G = H / KV FMAs per element (4 for Llama-3-8B), ~2 FLOP per byte, so the
// arithmetic stays plain float32 FMAs.  Measured at the generation path's
// shape, a stage's reduction (dot products, shuffles across the lanes of a
// row, online softmax, P.V) is a dependent chain that costs more than its
// loads, and a call has a fixed cost of launch, cur_len, fold and combine;
// the design keeps loads in flight and spreads each stage over many warps:
//
// - A block's K and V rows stream through a 4-stage ring in shared memory
//   (16 KB a stage, 64 KB dynamic), filled by 16-byte cp.async copies:
//   stages t+1 to t+3 are in flight while stage t is reduced.  Every thread
//   copies the 16-byte pieces that it later reads itself (HD / (16 /
//   sizeof(T)) neighbouring lanes cover one row, a lane group takes 2 rows
//   of each stage; where that would be more than a warp, float32 at HD 256,
//   a lane takes two neighbouring pieces of one row), so the ring needs no
//   barrier; keys at or past the block's last valid key are not copied.  A
//   stage is 16 KB at every head dim: it holds 512 keys at HD 8 (one lane a
//   bf16 row) and 16 at HD 256 (a warp a row).  Where a row's pieces are
//   not a power of two (HD 80: 10 bf16 or 20 float32 pieces) the row takes
//   the next power of two of lanes, so the shuffles that sum its dot
//   product stay inside its lanes, and the lanes past its pieces (6 of 16
//   in bf16, 12 of 32 in float32) copy nothing and add zeros: a stage then
//   holds 32 (bf16) or 16 (float32) whole key rows, as at HD 128 and 256,
//   in 16 KB of lane slots of which 10 KB are written.  8 warps a block (2 blocks
//   an SM) keep each warp's share of a stage short; a block takes at most 4
//   query heads (GB): at HD 256 8 heads' float32 partials (66 KB) would not
//   fit the ring's 64 KB for the fold, and at HD 128 8 heads take 212
//   registers a thread, one block an SM, slower on an H100 than two blocks
//   of 4 (15.2 against 10.1 us at qwen3-moe's decode, G = 8).
// - One launch: each block folds its lane groups (shuffles within a warp,
//   then the 8 warps through the ring's memory) into one float32 partial
//   (m, l, acc[GB][HD]) per chunk and writes it to a workspace, then takes
//   a ticket (a release-acquire atomic) from its (batch, head group)'s
//   counter.  The block that draws the last ticket combines the n_split
//   partials, writes the output and sets the counter back to 0, so repeated
//   calls and CUDA-graph replays find it at 0 (the wrapper allocates the
//   counters zeroed once).  The combine reads the partials' (m, l) and 16
//   bytes of columns of 8 chunks at a time, one L2 round trip per 8 chunks,
//   and merges them in split order, so the result does not depend on which
//   block came last.  With one split the block writes the output directly.
//
// cur_len is read on the device, as one int32 or one per row, so a decode
// step needs no host sync for it.
//
// The partial form (tensor-parallel decode over a sequence-sharded cache):
// slot s of the cache holds global position start + s (one host int for
// every row), and keys are masked by global position, [cur - window, cur) ∩ the cache's slots.  cur is never
// clamped to the cache's end, so a slice that ends before cur keeps the
// window's start.  Given an lse pointer, each (row, head) also writes its
// log-sum-exp (natural log) beside o: (m + log2 l) ln 2 from the (m, l) the
// combine already holds, -inf where no slot is valid (o is then 0).  The
// ranks merge their (o, lse) pairs outside the kernel.  The form is its own
// kernel, decode_attention_kernel_partial: both kernels inline one body
// (decode_attention_body) whose PARTIAL template parameter compiles the
// offset and the lse writes in or out, so the plain kernel takes the
// arguments and runs the code it did before the form existed.
//
// Chunks past cur_len, or before the window, load nothing (and still take
// their ticket).  Arithmetic is the TPU
// kernel's, in float32: q scaled before the product (by scale * log2(e), so
// the softmax is exp2 of scores in log2 units, the same function), P.V, and
// the output acc / max(l, 1e-30) in q's dtype.  Masked keys are skipped,
// which equals the kernel's exp(-2e38 - m) = 0 for every chunk that holds a
// valid key.

#include <stdint.h>

#include "sm90.cuh"

namespace {

namespace sm90 = repro_torch::sm90;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BLOCKS_PER_SM = 2;      // the wrapper's split_plan counts on it
constexpr int STAGES = 4;             // depth of the K/V ring
constexpr int PIECES = 2;             // 16-byte K (and V) pieces a thread copies per stage
constexpr int STAGE_BYTES = 16384;    // K rows, then V rows, of one stage
constexpr float NEG_INF = -2.0e38f;   // the Pallas kernel's mask value
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

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

// 4 float32 values to 4 consecutive elements of type T
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(sm90::pack_bf16(v.x, v.y), sm90::pack_bf16(v.z, v.w));
}

__device__ __forceinline__ void fma4(float4& acc, float4 x, float w) {
  acc.x = fmaf(x.x, w, acc.x);
  acc.y = fmaf(x.y, w, acc.y);
  acc.z = fmaf(x.z, w, acc.z);
  acc.w = fmaf(x.w, w, acc.w);
}

// Workspace layout, with P = B * (H / GB) * n_split partials (one per
// block): ws_acc [P][GB][HD] the unnormalised output, ws_ml [P][GB][2] its
// (m, l), m in log2 units.  counters [B * (H / GB)] are 0 between calls.
// the smallest power of two at or above n
__host__ __device__ constexpr int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

template <typename T, int HD, int GB, bool PARTIAL>
__device__ __forceinline__ void decode_attention_body(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ cur_len, int cur_per_row, T* __restrict__ o,
    float* __restrict__ ws_ml, float* __restrict__ ws_acc,
    unsigned* __restrict__ counters, int S, int H, int KV, int chunk, int window,
    float logit_cap, float scale, int start, float* __restrict__ lse) {
  constexpr int VEC = Pack<T>::N;        // elements per 16-byte piece
  // a lane takes PPL neighbouring pieces of a row: one, or two where one
  // piece a lane would need more than a warp for the row (float32, HD 256)
  constexpr int PPL = HD / VEC > 32 ? HD / VEC / 32 : 1;
  constexpr int E = VEC * PPL;           // elements of a row a lane holds
  constexpr int ACT = HD / E;            // lanes that hold a piece of a key row
  constexpr int TPK = pow2_at_least(ACT);  // lanes that share one key row
  static_assert(TPK <= 32 && ACT * E == HD, "unsupported head dim");
  constexpr int ROWS = PIECES / PPL;     // key rows a lane group takes per stage
  static_assert(ROWS >= 1 && ROWS * PPL == PIECES, "pieces per row");
  constexpr int NG = THREADS / TPK;      // lane groups in the block
  constexpr int KS = NG * ROWS;          // keys a stage holds
  static_assert(2 * KS * TPK * E * (int)sizeof(T) == STAGE_BYTES, "stage size");
  static_assert(WARPS * GB * (HD + 2) * 4 <= STAGES * STAGE_BYTES, "fold size");
  extern __shared__ uint4 ring[];       // STAGES * STAGE_BYTES (dynamic)

  const int n_split = gridDim.x;
  const int split = blockIdx.x;
  const int G = H / KV;
  const int per_kv = G / GB;
  const int hg = blockIdx.y;             // head group: GB heads of one KV head
  const int kvh = hg / per_kv;
  const int h0 = kvh * G + (hg % per_kv) * GB;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int t = tid % TPK;               // this lane's HD slice: [t*E, t*E+E)
  const int grp = tid / TPK;
  const bool act = ACT == TPK || t < ACT;  // the lane holds a slice of the row

  // q, scaled by scale * log2(e) (scores in log2 units, exp2), is loaded
  // while cur_len is
  float qv[GB][E];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
#pragma unroll
    for (int pc = 0; pc < PPL; ++pc)
      Pack<T>::unpack(act ? load16(q + ((size_t)b * H + h0 + g) * HD + t * E + pc * VEC)
                          : make_uint4(0u, 0u, 0u, 0u),
                      qv[g] + pc * VEC);
#pragma unroll
    for (int i = 0; i < E; ++i) qv[g][i] *= scale * LOG2E;
  }
  const size_t pos_stride = (size_t)KV * HD;  // elements between positions
  const T* kb = k + ((size_t)b * S * KV + kvh) * HD + t * E;
  const T* vb = v + ((size_t)b * S * KV + kvh) * HD + t * E;
  // valid keys: k_pos < cur and, with a window, k_pos > cur - 1 - window,
  // k_pos = start + slot; in slots, [cur - start - window, cur - start)
  const int cur = cur_len[cur_per_row ? b : 0] - (PARTIAL ? start : 0);
  int lo = split * chunk;
  const int hi = min(min(lo + chunk, S), cur);
  if (window > 0) lo = max(lo, cur - window);

  float m[GB], l[GB], acc[GB][E];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < E; ++i) acc[g][i] = 0.f;
  }

  if (lo < hi) {  // block-uniform: every lane reaches the shuffles
    const uint32_t ring0 = sm90::smem_addr(ring);
    const int n_t = (hi - lo + KS - 1) / KS;

    // stage slot of row grp + NG u, piece pc of this lane's slice:
    // (tid + THREADS (u PPL + pc)) * 16 bytes
    auto fetch = [&](int tile) {
      const uint32_t st = ring0 + (tile % STAGES) * STAGE_BYTES;
#pragma unroll
      for (int u = 0; u < ROWS; ++u) {
        const int s = lo + tile * KS + grp + NG * u;
        if (s < hi && act) {
#pragma unroll
          for (int pc = 0; pc < PPL; ++pc) {
            const uint32_t slot = (tid + THREADS * (u * PPL + pc)) * 16;
            sm90::cp_async16(st + slot, kb + s * pos_stride + pc * VEC, true);
            sm90::cp_async16(st + STAGE_BYTES / 2 + slot,
                             vb + s * pos_stride + pc * VEC, true);
          }
        }
      }
    };
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < n_t) fetch(st);
      sm90::cp_async_commit();
    }

    for (int tile = 0; tile < n_t; ++tile) {
      if (tile + STAGES - 1 < n_t) fetch(tile + STAGES - 1);
      sm90::cp_async_commit();
      sm90::cp_async_wait<STAGES - 1>();  // this thread's pieces of `tile`
      const uint4* st = ring + (tile % STAGES) * (STAGE_BYTES / 16);
      const int base = lo + tile * KS;

      uint4 kr[PIECES], vr[PIECES];        // piece u PPL + pc: row u, piece pc
      bool ok[ROWS];
#pragma unroll
      for (int u = 0; u < ROWS; ++u) {
        ok[u] = base + grp + NG * u < hi;
        const bool copied = ok[u] && act;  // an idle lane's slot holds nothing
#pragma unroll
        for (int pc = 0; pc < PPL; ++pc) {
          const int j = u * PPL + pc;
          kr[j] = copied ? st[tid + THREADS * j] : make_uint4(0u, 0u, 0u, 0u);
          vr[j] = copied ? st[STAGE_BYTES / 32 + tid + THREADS * j]
                         : make_uint4(0u, 0u, 0u, 0u);
        }
      }

      float sc[ROWS * GB];                 // score of key u, head g at u GB + g
#pragma unroll
      for (int u = 0; u < ROWS; ++u) {
        float kf[E];
#pragma unroll
        for (int pc = 0; pc < PPL; ++pc)
          Pack<T>::unpack(kr[u * PPL + pc], kf + pc * VEC);
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          float dot = 0.f;
#pragma unroll
          for (int i = 0; i < E; ++i) dot = fmaf(qv[g][i], kf[i], dot);
          sc[u * GB + g] = dot;
        }
      }
      // sum the partial dot products over the TPK lanes of each key row
#pragma unroll
      for (int off = TPK / 2; off > 0; off >>= 1)
#pragma unroll
        for (int i = 0; i < ROWS * GB; ++i)
          sc[i] += __shfl_xor_sync(0xffffffffu, sc[i], off);

      // online softmax over this group's ROWS keys: one rescale per stage
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float tmax = NEG_INF;
#pragma unroll
        for (int u = 0; u < ROWS; ++u) {
          if (ok[u]) {
            float s = sc[u * GB + g];
            if (logit_cap > 0.f)
              s = logit_cap * tanhf(s / (logit_cap * LOG2E)) * LOG2E;
            sc[u * GB + g] = s;
            tmax = fmaxf(tmax, s);
          }
        }
        const float m_new = fmaxf(m[g], tmax);
        const float corr = exp2f(m[g] - m_new);
        m[g] = m_new;
        l[g] *= corr;
#pragma unroll
        for (int i = 0; i < E; ++i) acc[g][i] *= corr;
#pragma unroll
        for (int u = 0; u < ROWS; ++u) {
          sc[u * GB + g] = ok[u] ? exp2f(sc[u * GB + g] - m_new) : 0.f;
          l[g] += sc[u * GB + g];
        }
      }
#pragma unroll
      for (int u = 0; u < ROWS; ++u) {
        if (!ok[u]) continue;
        float vf[E];
#pragma unroll
        for (int pc = 0; pc < PPL; ++pc)
          Pack<T>::unpack(vr[u * PPL + pc], vf + pc * VEC);
#pragma unroll
        for (int g = 0; g < GB; ++g)
#pragma unroll
          for (int i = 0; i < E; ++i) acc[g][i] = fmaf(sc[u * GB + g], vf[i], acc[g][i]);
      }
    }
  }

  // fold the lane groups of each warp (same piece t, other rows) ...
#pragma unroll
  for (int off = TPK; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float ws = exp2f(m[g] - mn), wo = exp2f(mo - mn);
      l[g] = l[g] * ws + lo_ * wo;
#pragma unroll
      for (int i = 0; i < E; ++i)
        acc[g][i] = acc[g][i] * ws +
                    __shfl_xor_sync(0xffffffffu, acc[g][i], off) * wo;
      m[g] = mn;
    }
  }
  // ... then the warps, through the ring's memory
  __syncthreads();  // every thread is done reading the ring
  float* f_acc = reinterpret_cast<float*>(ring);        // [WARPS][GB][HD]
  float* f_ml = f_acc + WARPS * GB * HD;                // [WARPS][GB][2]
  if (lane < ACT) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
#pragma unroll
      for (int i = 0; i < E; ++i)
        f_acc[(warp * GB + g) * HD + t * E + i] = acc[g][i];
      if (lane == 0) {
        f_ml[(warp * GB + g) * 2] = m[g];
        f_ml[(warp * GB + g) * 2 + 1] = l[g];
      }
    }
  }
  __syncthreads();

  // the block's partial: each thread takes 4 consecutive columns of a head
  constexpr int NV4 = GB * HD / 4;       // float4 pieces of one partial
  const size_t part0 = ((size_t)b * gridDim.y + hg) * n_split;
  const float4* f_acc4 = reinterpret_cast<const float4*>(f_acc);
  float4* ws_acc4 = reinterpret_cast<float4*>(ws_acc);
  T* ob = o + ((size_t)b * H + h0) * HD;
  for (int e = tid; e < NV4; e += THREADS) {
    const int g = e / (HD / 4);
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, f_ml[(w * GB + g) * 2]);
    float ls = 0.f;
    float4 as = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wt = exp2f(f_ml[(w * GB + g) * 2] - mx);
      ls = fmaf(f_ml[(w * GB + g) * 2 + 1], wt, ls);
      fma4(as, f_acc4[w * NV4 + e], wt);
    }
    if (n_split == 1) {
      const float r = 1.f / fmaxf(ls, 1e-30f);
      store4(ob + 4 * e, make_float4(as.x * r, as.y * r, as.z * r, as.w * r));
      if constexpr (PARTIAL) {
        if (lse && e % (HD / 4) == 0)
          lse[(size_t)b * H + h0 + g] =
              ls > 0.f ? (mx + log2f(ls)) * LN2 : __uint_as_float(0xff800000u);
      }
    } else {
      ws_acc4[(part0 + split) * NV4 + e] = as;
      if (e % (HD / 4) == 0) {
        ws_ml[((part0 + split) * GB + g) * 2] = mx;
        ws_ml[((part0 + split) * GB + g) * 2 + 1] = ls;
      }
    }
  }
  if (n_split == 1) return;

  // the last block of this (batch, head group) to finish combines the
  // chunks.  The barrier orders the block's partial before thread 0's
  // ticket, whose release makes it visible at gpu scope; the last ticket's
  // acquire, and the barrier after it, order the other partials before the
  // combine's loads (the pattern of CUTLASS's split-K semaphore).
  __syncthreads();
  unsigned ticket = 0;
  unsigned* counter = counters + (size_t)b * gridDim.y + hg;
  if (tid == 0) ticket = sm90::atomic_add_acq_rel(counter, 1u);
  if (!__syncthreads_or(tid == 0 && ticket == (unsigned)n_split - 1)) return;
  // each thread merges its 4 columns over the chunks, 8 chunks' (m, l) and
  // columns loaded at a time (one round of loads in flight), with a running
  // max as in the online softmax
  const float2* ml2 = reinterpret_cast<const float2*>(ws_ml) + part0 * GB;
  for (int e = tid; e < NV4; e += THREADS) {
    const int g = e / (HD / 4);
    float mx = NEG_INF, ls = 0.f;
    float4 as = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4* src = ws_acc4 + part0 * NV4 + e;
    for (int s0 = 0; s0 < n_split; s0 += 8) {
      float4 buf[8];
      float2 ml[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bool in = s0 + j < n_split;
        buf[j] = in ? __ldcg(src + (size_t)(s0 + j) * NV4)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
        ml[j] = in ? __ldcg(ml2 + (size_t)(s0 + j) * GB + g)
                   : make_float2(NEG_INF, 0.f);
      }
      float bm = mx;
#pragma unroll
      for (int j = 0; j < 8; ++j) bm = fmaxf(bm, ml[j].x);
      const float c = exp2f(mx - bm);
      ls *= c;
      as = make_float4(as.x * c, as.y * c, as.z * c, as.w * c);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float wt = exp2f(ml[j].x - bm);
        ls = fmaf(ml[j].y, wt, ls);
        fma4(as, buf[j], wt);
      }
      mx = bm;
    }
    const float r = 1.f / fmaxf(ls, 1e-30f);
    store4(ob + 4 * e, make_float4(as.x * r, as.y * r, as.z * r, as.w * r));
    if constexpr (PARTIAL) {
      if (lse && e % (HD / 4) == 0)
        lse[(size_t)b * H + h0 + g] =
            ls > 0.f ? (mx + log2f(ls)) * LN2 : __uint_as_float(0xff800000u);
    }
  }
  if (tid == 0) *counter = 0u;
}

template <typename T, int HD, int GB>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ cur_len,
                        int cur_per_row, T* __restrict__ o,
                        float* __restrict__ ws_ml, float* __restrict__ ws_acc,
                        unsigned* __restrict__ counters, int S, int H, int KV,
                        int chunk, int window, float logit_cap, float scale) {
  decode_attention_body<T, HD, GB, false>(q, k, v, cur_len, cur_per_row, o, ws_ml,
                                          ws_acc, counters, S, H, KV, chunk,
                                          window, logit_cap, scale, 0, nullptr);
}

// the partial form: slot 0 at global position start, lse beside o
template <typename T, int HD, int GB>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
decode_attention_kernel_partial(const T* __restrict__ q, const T* __restrict__ k,
                                const T* __restrict__ v,
                                const int* __restrict__ cur_len, int cur_per_row,
                                T* __restrict__ o, float* __restrict__ ws_ml,
                                float* __restrict__ ws_acc,
                                unsigned* __restrict__ counters, int S, int H,
                                int KV, int chunk, int window, float logit_cap,
                                float scale, int start, float* __restrict__ lse) {
  decode_attention_body<T, HD, GB, true>(q, k, v, cur_len, cur_per_row, o, ws_ml,
                                         ws_acc, counters, S, H, KV, chunk, window,
                                         logit_cap, scale, start, lse);
}

template <typename T, int HD, int GB>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* cur_len, int cur_per_row, void* o, float* ws_ml,
                   float* ws_acc, unsigned* counters, int B, int S, int H,
                   int KV, int n_split, int chunk, int window, float logit_cap,
                   float scale, int start, float* lse, cudaStream_t stream) {
  constexpr int smem = STAGES * STAGE_BYTES;
  const bool partial = start != 0 || lse != nullptr;
  cudaError_t err = partial
      ? cudaFuncSetAttribute(decode_attention_kernel_partial<T, HD, GB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
      : cudaFuncSetAttribute(decode_attention_kernel<T, HD, GB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_split, H / GB, B);
  if (partial)
    decode_attention_kernel_partial<T, HD, GB><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), cur_len, cur_per_row, static_cast<T*>(o),
        ws_ml, ws_acc, counters, S, H, KV, chunk, window, logit_cap, scale,
        start, lse);
  else
    decode_attention_kernel<T, HD, GB><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), cur_len, cur_per_row, static_cast<T*>(o),
        ws_ml, ws_acc, counters, S, H, KV, chunk, window, logit_cap, scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dispatch_gb(int GB, const void* q, const void* k, const void* v,
                        const int* cur_len, int cur_per_row, void* o,
                        float* ws_ml, float* ws_acc, unsigned* counters, int B,
                        int S, int H, int KV, int n_split, int chunk,
                        int window, float logit_cap, float scale, int start,
                        float* lse, cudaStream_t stream) {
#define REPRO_DECODE_LAUNCH(gb)                                               \
  return launch<T, HD, gb>(q, k, v, cur_len, cur_per_row, o, ws_ml, ws_acc,  \
                           counters, B, S, H, KV, n_split, chunk, window,    \
                           logit_cap, scale, start, lse, stream)
  switch (GB) {
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
                        void* o, float* ws_ml, float* ws_acc,
                        unsigned* counters, int B, int S, int H, int KV,
                        int n_split, int chunk, int window, float logit_cap,
                        float scale, int start, float* lse,
                        cudaStream_t stream) {
#define REPRO_DECODE_HD(hd)                                                  \
  return dispatch_gb<T, hd>(GB, q, k, v, cur_len, cur_per_row, o, ws_ml,    \
                            ws_acc, counters, B, S, H, KV, n_split, chunk,  \
                            window, logit_cap, scale, start, lse, stream)
  switch (HD) {
    case 8: REPRO_DECODE_HD(8);
    case 16: REPRO_DECODE_HD(16);
    case 32: REPRO_DECODE_HD(32);
    case 64: REPRO_DECODE_HD(64);
    case 80: REPRO_DECODE_HD(80);
    case 128: REPRO_DECODE_HD(128);
    case 256: REPRO_DECODE_HD(256);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_DECODE_HD
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  q/o are contiguous
// [B, H, HD], k/v contiguous [B, S, KV, HD], all of the storage type is_bf16
// selects (1 bfloat16, 0 float32) and 16-byte aligned; cur_len is int32, one
// value (cur_per_row 0) or B values (1), on the device.  With n_split > 1,
// ws_acc holds B * H * n_split * HD floats (16-byte aligned), ws_ml
// B * H * n_split * 2 (8-byte aligned), and counters B * H / GB unsigned
// ints that are 0 (and are 0 again when the kernel ends); chunk * n_split
// must cover S.  GB, the query heads a block
// takes, is chosen by the caller (the wrapper's heads_per_block): one of 4,
// 2, 1 that divides H / KV.  Slot 0 holds global position start; lse,
// where not null, takes B * H floats.
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* cur_len, int cur_per_row,
                                    void* o, void* ws_ml, void* ws_acc,
                                    void* counters, int is_bf16, int B, int S,
                                    int H, int KV, int HD, int GB, int n_split,
                                    int chunk, int window, float logit_cap,
                                    float scale, int start, void* lse,
                                    void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || GB <= 0 ||
      (H / KV) % GB != 0 || n_split <= 0 || chunk <= 0 ||
      (long long)chunk * n_split < S ||
      (n_split > 1 && (!ws_ml || !ws_acc || !counters)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* cl = static_cast<const int*>(cur_len);
  float* ml = static_cast<float*>(ws_ml);
  float* ac = static_cast<float*>(ws_acc);
  unsigned* cn = static_cast<unsigned*>(counters);
  float* ls = static_cast<float*>(lse);
  if (is_bf16)
    return dispatch_hd<__nv_bfloat16>(HD, GB, q, k, v, cl, cur_per_row, o, ml,
                                      ac, cn, B, S, H, KV, n_split, chunk,
                                      window, logit_cap, scale, start, ls, st);
  return dispatch_hd<float>(HD, GB, q, k, v, cl, cur_per_row, o, ml, ac, cn, B,
                            S, H, KV, n_split, chunk, window, logit_cap, scale,
                            start, ls, st);
}
