// Mamba-2 SSD chunk scan for Hopper (sm_90a): chunked state-space duality
// with a carried float32 state.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_chunk.py (_ssd_kernel,
// called by ssd_chunk) together with the model path
// src/repro/models/mamba2.py::ssd_chunked.  Per chunk of Q steps of one
// (batch, head):
//   cums = cumsum(dt * A)
//   y    = ((C B^T) o L) (dt x) + (C o e^cums) S,  L[i,j] = e^(cums_i - cums_j), j <= i
//   S   <- S e^cums[-1] + (B o e^(cums[-1] - cums))^T (dt x)
// with S the [N, P] float32 state carried across chunks, seeded from
// state_in (or zero) and returned.  The TPU kernel carries S in VMEM along
// its sequential minor grid axis; here the chunks run in parallel and only
// the carry of S is sequential.
//
// Layout: x [B, S, H, P] and B/C [B, S, G, N] with their last two dims
// contiguous and any stride between batch rows and positions (the model
// passes slices of the conv output); dt [B, S, H] float32; A [H] float32;
// y [B, S, H, P] contiguous in x's type; states [B, H, N, P] float32.  Query
// head h reads group h / (H / G).  The ragged S edge is masked here: steps
// past S have dt = 0 in the reference's padding, which leaves the state
// unchanged, so masking gives the same final state.
//
// What bounds it on the H100: at the Mamba-2 prefill shape (B=1, S=512,
// H=64, P=64, G=1, N=128, Q=256, final state returned) bytes, 10.9 MB (3.2
// us), against 1.63 GFLOP of products that input needs (1.7 us at the bf16
// tensor rate).  Both are small: what the design must avoid is float32
// FMAs, a sequential walk over the chunks, and chains of dependent
// memory round trips (~1-2 us each on the card) inside a block.
//
// bfloat16 (the model path): two launches, every product on the tensor
// cores (wgmma, sw128 tiles of sm90.cuh fed by 16-byte cp.async, or by
// element-by-element loads where a view is not 16-byte aligned):
//  1. ssd_chunk_state_kernel, one block per (batch * head, chunk, 64
//     columns of P), one warpgroup per 64 rows of N: cums by a block scan
//     of dt * A, then the chunk's own state S^_c = (B o w)^T x with
//     w_j = dt_j e^(cums[-1] - cums_j), streamed over 64-step tiles through
//     a ring of 4 stages (2 when N > 128).  w is folded into B, so x stays an exact bf16
//     operand; B o w is float32, split into bf16 halves hi = bf16(v),
//     lo = bf16(v - hi) and multiplied twice (relative error ~2^-16, which
//     the 1e-4 state tolerance needs); B o w is read MN-major (trans-a), x
//     N-major (trans-b).  The carry follows in the same launch: the last
//     block of each (batch * head, P tile) to finish, found by a
//     release-acquire ticket on a counter that it resets, walks the chunks
//     in order, S_in(0) = state_in or 0, S_in(c+1) = S_in(c) e^cums_c[-1] +
//     S^_c in float32, and writes each S_in as the bf16 halves kernel 2
//     reads, and the final state.  (A launch of its own for the carry
//     would cost ~2 us of ramp on the card; the ticket costs ~1 us.)
//  2. ssd_chunk_scan_kernel, one block per (batch * head * P tile, chunk,
//     group of 4 row tiles, 2 when N > 192), one warpgroup per 64-row tile:
//     y_i = sum over j-tiles on or below the diagonal of
//     bf16((C B^T) o L o dt_j) x_j + e^cums_i (C S_in)_i, C exact and S_in
//     as hi + lo.  C B^T is K1's Q K^T (SS wgmma, both K-major), the masked
//     scores are the register A operand of an RS wgmma against x_j (K1's
//     P V); the block loads each (B_j, x_j) tile once for its warpgroups,
//     through a ring of 4 stages (2 when N > 128).  L's exponentials are single MUFU ex2.approx
//     (the scores are rounded to bf16 next).  L is masked before exp (for j > i,
//     cums_i - cums_j can be positive and exp overflow; inf * 0 would be
//     NaN); tiles above the diagonal are skipped.  It is a programmatic
//     dependent launch: its blocks start on the SMs kernel 1 frees and copy
//     the input tiles, then griddepcontrol.wait holds them until kernel 1
//     has ended before they read cums and S_in.
// No atomics in any sum: two calls give the same bits.
//
// float32 (training calls it, and the checks): every product 3xTF32 on the
// tensor cores (mma.sync.m16n8k8 fragments split into big + small TF32 parts
// by tf32x3.cuh: float32 accuracy at a third of the TF32 rate; one TF32
// product misses the 1e-4 tolerance, tests/test_torch_ssd_plan.py), in
// three launches:
//  1. ssd_cb_kernel: C B^T once per (batch, group, chunk), in 64 x 64 tiles
//     on and below the diagonal, into scratch (1 MB at the training shape,
//     so it stays in L2); no block recomputes it for a head;
//  2. ssd_state_kernel (forward): the chunk-parallel state pass of
//     ssd_f32.cuh: per (batch * head, chunk, 64 columns of P) cums by a
//     block scan and the chunk's own state S^_c = (B o w)^T (dt x), then the
//     carry S_in(c + 1) = S_in(c) e^last_c + S^_c in float32 by the last
//     block of each (batch * head, P tile) to finish (the bf16 instance's
//     ticket, on the same counters), writing S_in per chunk over the chunk
//     states, and the final state if asked (without it the last chunk's own
//     state is dead, and its block skips the product);
//  3. ssd_y_kernel, one block per (batch * head * P tile, chunk, 64-row tile
//     I), the tiles with the most pairs first: y_I = e^cums_I (C_I S_in) +
//     sum over J <= I of ((C B^T)_IJ o L_IJ)(dt x)_J, the masked scores
//     going from registers into the A fragments of the product with x (L's
//     exponentials once per (head, tile pair), masked before exp).
// The fragments read shared tiles laid out for the orientation they read
// them in (ssd_f32.cuh), fed by 16-byte cp.async where every view is
// 16-byte aligned, else element by element.  What bounds it at Mamba-2's
// training shape (B=2, S=512, H=64, P=64, G=1, N=128, chunk 256, no
// state_in, no final state): 2.19 GFLOP of float32-accurate products
// (13.2 us as 3xTF32 at 495 TFLOP/s; chunk 0's C S_in and the last chunk's
// own state are not needed) against 34.9 MB moved.  mma.sync runs far
// below that rate: each product costs three HMMA and the splits of its
// fragments.

#include <stdint.h>

#include "sm90.cuh"
#include "ssd_f32.cuh"
#include "tf32x3.cuh"

namespace {

namespace sm90 = repro_torch::sm90;
using bf16 = __nv_bfloat16;

// every kernel asks for the largest shared-memory carveout, so consecutive
// launches do not reconfigure the SMs
template <typename K>
cudaError_t set_smem(K* kernel, int bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess || bytes <= 48 * 1024) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// ===========================================================================
// float32: 3xTF32 on the tensor cores (mma.sync)
// ===========================================================================

namespace f32 = repro_torch::ssd_f32;
using f32::H2;
using f32::ld4;
using f32::ld8;
using f32::round_up;
using repro_torch::tf32x3::acc_as_a;
using repro_torch::tf32x3::mma3;
using repro_torch::tf32x3::Split;

constexpr int F_THREADS = 128;   // cb and y: four warps, 16 rows of a tile each

// ---------------------------------------------------------------------------
// ssd_cb_kernel: cb[bg][c][i][j] = C_i . B_j (rows c Q + i, c Q + j; 0 past
// len) on the tile pairs it >= jt, in 64 x 64 tiles of a [QP, QP] block per
// (batch * group, chunk); the 8 x 8 blocks above the diagonal are written as
// 0, tiles above it never.  B and C are per group, so the H / G heads of a
// group share it.  grid (tile pairs, nc, B * G); the block loads its rows
// of C and B whole, in one batch of copies.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cb_tiles(const float* __restrict__ bm,
                                         const float* __restrict__ cm,
                                         float* __restrict__ cb, int S, int G, int N,
                                         int Q, int QP, int nc, long long b_sb,
                                         long long b_ss, long long c_sb,
                                         long long c_ss, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int nk = round_up(N, 8), ldk = ld4(nk);
  float* Cs = smem;                           // C_I [64][ldk]
  float* Bs = smem + f32::T * ldk;            // B_J [64][ldk]
  int t = blockIdx.x, it = 0;
  while ((it + 1) * (it + 2) / 2 <= t) ++it;
  const int jt = t - it * (it + 1) / 2;
  const int c = blockIdx.y, bg = blockIdx.z, b = bg / G, g = bg % G;
  const int c0 = c * Q, len = min(Q, S - c0);
  const int i0 = it * f32::T, j0 = jt * f32::T;
  if (i0 >= len) return;                      // past the ragged edge: never read
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5, r0 = 16 * w;
  f32::load_tile(Cs, ldk, cm + b * c_sb + (long long)(c0 + i0) * c_ss + (long long)g * N,
                 c_ss, f32::T, nk, len - i0, N, vec, tid, F_THREADS);
  f32::load_tile(Bs, ldk, bm + b * b_sb + (long long)(c0 + j0) * b_ss + (long long)g * N,
                 b_ss, f32::T, nk, len - j0, N, vec, tid, F_THREADS);
  sm90::cp_async_commit();
  // on the diagonal, warp w's rows need the columns j <= 16 w + 15 only
  const int nb_end = it == jt ? 2 * w + 2 : 8;
  float acc[8][4];
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) f32::zero(acc[nb]);
  sm90::cp_async_wait<0>();
  __syncthreads();
  for (int kk = 0; kk < nk; kk += 8) {
    const auto a = f32::frag_a(Cs, ldk, r0, kk, lane);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
      if (nb < nb_end) mma3(acc[nb], a, f32::frag_b_t(Bs, ldk, 8 * nb, kk, lane));
  }
  float* out = cb + ((size_t)bg * nc + c) * QP * QP +
               (size_t)(i0 + r0 + (lane >> 2)) * QP + j0 + 2 * (lane & 3);
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    *reinterpret_cast<float2*>(out + 8 * nb) = make_float2(acc[nb][0], acc[nb][1]);
    *reinterpret_cast<float2*>(out + 8 * QP + 8 * nb) = make_float2(acc[nb][2], acc[nb][3]);
  }
}

// the forward's launch, and the backward's (a name of its own, so that a
// trace tells the two apart)
__global__ void __launch_bounds__(F_THREADS)
ssd_cb_kernel(const float* __restrict__ bm, const float* __restrict__ cm,
              float* __restrict__ cb, int S, int G, int N, int Q, int QP, int nc,
              long long b_sb, long long b_ss, long long c_sb, long long c_ss, int vec) {
  cb_tiles(bm, cm, cb, S, G, N, Q, QP, nc, b_sb, b_ss, c_sb, c_ss, vec);
}

__global__ void __launch_bounds__(F_THREADS)
ssd_bwd_cb_kernel(const float* __restrict__ bm, const float* __restrict__ cm,
                  float* __restrict__ cb, int S, int G, int N, int Q, int QP, int nc,
                  long long b_sb, long long b_ss, long long c_sb, long long c_ss,
                  int vec) {
  cb_tiles(bm, cm, cb, S, G, N, Q, QP, nc, b_sb, b_ss, c_sb, c_ss, vec);
}

// ---------------------------------------------------------------------------
// ssd_state_kernel: the chunk-parallel state pass (ssd_f32.cuh).  grid
// (B * H, nc, ceil(P / 64)), eight warps; warp w computes the state rows
// [16 m, 16 m + 16) for m = w (and w + 8 when MT = 2, N > 128) of the
// chunk's own hat[n][p] = sum_j U_j[n] (om_j V_j[p]) over 64 columns of P,
// the chunk's steps streamed 32 at a time through a ring of three stages
// (two blocks an SM at N <= 128).  The last
// block of each (batch * head, P tile) to finish carries the sum.
// ---------------------------------------------------------------------------
constexpr int ST_THREADS = 256;
constexpr int ST_NST = 3;                    // ring stages
constexpr int ST_LDV = ld8(f32::T);          // V [32][64], read down columns

int state_smem_floats(int N, int QP) {
  return ST_NST * H2 * (ld8(N) + ST_LDV) + 2 * QP + ST_THREADS / 32;
}

template <int MT>
__device__ __forceinline__ void state_pass(
    const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ dt, const float* __restrict__ A,
    const float* __restrict__ init, float* hat, float* out, float* __restrict__ fin,
    float* __restrict__ cums_out, float* __restrict__ last_out,
    unsigned* __restrict__ counters, int rev, int S, int H, int G, int N, int P, int Q,
    int QP, int nc, int npt, long long u_sb, long long u_ss, long long v_sb,
    long long v_ss, int vec) {
  constexpr int NTHR = ST_THREADS;
  const int ldu = ld8(N), NU = round_up(N, 16);   // U columns its fragments read
  const int stage = H2 * (ldu + ST_LDV);
  extern __shared__ __align__(16) float smem[];
  float* cums = smem + ST_NST * stage;       // [QP]
  float* om = cums + QP;                     // [QP] the rows' weights
  float* wsum = om + QP;                     // [NTHR / 32]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t2 = 2 * (lane & 3);
  const int bh = blockIdx.x, c = blockIdx.y, pt = blockIdx.z;
  const int b = bh / H, h = bh % H, g = h / (H / G);
  const int c0 = c * Q, len = min(Q, S - c0), p0 = pt * f32::T;
  const float* ub = u + b * u_sb + (long long)c0 * u_ss + (long long)g * N;
  const float* vb = v + b * v_sb + (long long)c0 * v_ss + (long long)h * P + p0;
  const float* dtb = dt + ((size_t)b * S + c0) * H + h;
  // no carry reads the last chunk's own state forward (the first's
  // reversed) unless fin is asked for: that chunk skips its product
  const bool dead = fin == nullptr && c == (rev ? 0 : nc - 1);
  const int nsteps = dead ? 0 : (len + H2 - 1) / H2;
  auto load = [&](int s) {                   // one commit group a step, empty past the end
    if (s < nsteps) {
      float* st = smem + (s % ST_NST) * stage;
      const int j0 = s * H2;
      f32::load_tile(st, ldu, ub + (long long)j0 * u_ss, u_ss, H2, NU, len - j0, N, vec,
                     tid, NTHR);
      f32::load_tile(st + H2 * ldu, ST_LDV, vb + (long long)j0 * v_ss, v_ss, H2, f32::T,
                     len - j0, P - p0, vec, tid, NTHR);
    }
    sm90::cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < ST_NST - 1; ++s) load(s);

  // cums: thread t scans steps [t per, (t + 1) per) (past len, dt = 0), then
  // the threads' totals are scanned (the bf16 instance's scan)
  const float a = A[h];
  const int per = (QP + NTHR - 1) / NTHR;    // <= 4 (QP <= 1024)
  float dv[4], loc[4], run = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = tid * per + k;
    dv[k] = k < per && i < len ? dtb[(size_t)i * H] : 0.f;
    run += dv[k] * a;
    loc[k] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) wsum[warp] = incl;
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  __syncthreads();
  for (int v2 = 0; v2 < warp; ++v2) excl += wsum[v2];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = tid * per + k;
    if (k < per && i < QP) cums[i] = loc[k] + excl;
  }
  __syncthreads();
  const float last = cums[QP - 1];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = tid * per + k;
    if (k < per && i < QP) om[i] = rev ? expf(cums[i]) : dv[k] * expf(last - cums[i]);
  }
  if (cums_out != nullptr && pt == 0)
    for (int i = tid; i < QP; i += NTHR) cums_out[((size_t)bh * nc + c) * QP + i] = cums[i];
  if (tid == 0) last_out[(size_t)bh * nc + c] = last;   // each P tile's carry reads it

  float acc[MT][8][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) f32::zero(acc[m][nb]);
  for (int s = 0; s < nsteps; ++s) {
    sm90::cp_async_wait<ST_NST - 2>();
    __syncthreads();                         // step s (and om) for every thread; s - 1 consumed
    load(s + ST_NST - 1);
    const float* Us = smem + (s % ST_NST) * stage;
    const float* Vs = Us + H2 * ldu;
    const float* os = om + s * H2;
#pragma unroll
    for (int kk = 0; kk < H2; kk += 8) {
      Split<2> bf[8];
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) bf[nb] = f32::frag_b(Vs, ST_LDV, kk, 8 * nb, lane, os);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int m0 = 16 * (warp + 8 * m);
        if (m0 < N) {
          const auto af = f32::frag_a_t(Us, ldu, m0, kk, lane);
#pragma unroll
          for (int nb = 0; nb < 8; ++nb) mma3(acc[m][nb], af, bf[nb]);
        }
      }
    }
  }
  const size_t cs = (size_t)N * P;           // one chunk's [N, P]
  float* hb = hat + ((size_t)bh * nc + c) * cs;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int m0 = 16 * (warp + 8 * m);
    if (m0 >= N) continue;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const int p = p0 + 8 * nb + t2;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int n = m0 + gq + 8 * hf;
        if (n >= N) continue;
        if (p < P) hb[(size_t)n * P + p] = acc[m][nb][2 * hf];
        if (p + 1 < P) hb[(size_t)n * P + p + 1] = acc[m][nb][2 * hf + 1];
      }
    }
  }

  // The carry, by the last block of this (batch * head, P tile).  Every
  // thread's fence and the barrier order the block's hat before thread 0's
  // ticket, whose release makes it visible at gpu scope; the last ticket's
  // acquire, and the barrier after it, order the other chunks' hat before
  // the carry's loads (which bypass L1).
  __threadfence();
  __syncthreads();
  unsigned ticket = 0;
  unsigned* counter = counters + (size_t)bh * npt + pt;
  if (tid == 0) ticket = sm90::atomic_add_acq_rel(counter, 1u);
  if (!__syncthreads_or(tid == 0 && ticket == (unsigned)nc - 1)) return;
  // thread tid carries the elements e = e0 + tid + NTHR k of the [N, pw]
  // tile; chunk cc's stores overlap chunk cc's successor's loads
  constexpr int EG = 16;
  const int pw = min(f32::T, P - p0), ne = N * pw;
  const float* lb = last_out + (size_t)bh * nc;
  for (int e0 = 0; e0 < ne; e0 += NTHR * EG) {
    int off[EG];
    float sv[EG], add[EG];
#pragma unroll
    for (int k = 0; k < EG; ++k) {
      const int e = e0 + tid + NTHR * k, n = e / pw;
      off[k] = e < ne ? n * P + p0 + (e - n * pw) : -1;
      sv[k] = off[k] >= 0 && init != nullptr ? init[(size_t)bh * cs + off[k]] : 0.f;
      add[k] = off[k] >= 0 ? __ldcg(hat + ((size_t)bh * nc + (rev ? nc - 1 : 0)) * cs + off[k])
                           : 0.f;
    }
    for (int step = 0; step < nc; ++step) {
      const int cc = rev ? nc - 1 - step : step, cn = rev ? cc - 1 : cc + 1;
      float nx[EG];
#pragma unroll
      for (int k = 0; k < EG; ++k)
        nx[k] = step + 1 < nc && off[k] >= 0
                    ? __ldcg(hat + ((size_t)bh * nc + cn) * cs + off[k]) : 0.f;
      const float decay = expf(__ldcg(lb + cc));
      float* ob = out + ((size_t)bh * nc + cc) * cs;
#pragma unroll
      for (int k = 0; k < EG; ++k) {
        if (off[k] >= 0) ob[off[k]] = sv[k];
        sv[k] = fmaf(sv[k], decay, add[k]);
        add[k] = nx[k];
      }
    }
    if (fin != nullptr)
#pragma unroll
      for (int k = 0; k < EG; ++k)
        if (off[k] >= 0) fin[(size_t)bh * cs + off[k]] = sv[k];
  }
  if (tid == 0) *counter = 0u;
}

#define REPRO_SSD_STATE_KERNEL(name)                                             \
  template <int MT>                                                              \
  __global__ void __launch_bounds__(ST_THREADS, 3 - MT) name(                    \
      const float* __restrict__ u, const float* __restrict__ v,                  \
      const float* __restrict__ dt, const float* __restrict__ A,                 \
      const float* __restrict__ init, float* hat, float* out,                    \
      float* __restrict__ fin, float* __restrict__ cums_out,                     \
      float* __restrict__ last_out, unsigned* __restrict__ counters, int rev,    \
      int S, int H, int G, int N, int P, int Q, int QP, int nc, int npt,         \
      long long u_sb, long long u_ss, long long v_sb, long long v_ss, int vec) { \
    state_pass<MT>(u, v, dt, A, init, hat, out, fin, cums_out, last_out,         \
                   counters, rev, S, H, G, N, P, Q, QP, nc, npt, u_sb, u_ss,     \
                   v_sb, v_ss, vec);                                             \
  }
// the forward's launch, and the backward's two (names of their own)
REPRO_SSD_STATE_KERNEL(ssd_state_kernel)
REPRO_SSD_STATE_KERNEL(ssd_bwd_state_kernel)
#undef REPRO_SSD_STATE_KERNEL

// ---------------------------------------------------------------------------
// ssd_y_kernel: y.  grid (B * H * npt, nc, QP / 64); a block owns the 64-row
// tile I = QP / 64 - 1 - blockIdx.z of a chunk (the tiles with the most
// pairs launch first) and 64 columns of P; warp w owns its rows [16 w,
// 16 w + 16).  Its steps stream through a ring of Y_NST stages: first the
// carried state, e^cums_i (C_I S_in), over slabs of 32 columns of C and
// rows of S_in; then for each half tile of J <= I (32 steps j) the scores
// (C B^T)_ij e^(cums_i - cums_j) (C B^T from ssd_cb_kernel's scratch, masked
// before exp) go from registers into the A fragments of the product with
// dt_j x_j.
// ---------------------------------------------------------------------------
constexpr int Y_NST = 2;                      // ring stages
constexpr int Y_LDC = ld4(H2);                // C slab [64][32], read by frag_a
constexpr int Y_LDS = ld8(f32::T);            // S_in slab [32][64], read down columns
constexpr int Y_LDX = ld4(f32::T);            // x half [32][64], read by frag_b_perm
constexpr int Y_LDQ = ld8(H2);                // C B^T half [64 i][32 j], read as accumulators
constexpr int Y_STAGE = (f32::T * Y_LDC + H2 * Y_LDS) > (H2 * Y_LDX + f32::T * Y_LDQ)
                            ? f32::T * Y_LDC + H2 * Y_LDS : H2 * Y_LDX + f32::T * Y_LDQ;

__global__ void __launch_bounds__(F_THREADS)
ssd_y_kernel(const float* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ cm, const float* __restrict__ cb,
             const float* __restrict__ cums_g, const float* __restrict__ s_in,
             float* __restrict__ y, int S, int H, int G, int N, int P, int Q, int QP,
             int nc, int npt, int has_state, long long x_sb, long long x_ss,
             long long c_sb, long long c_ss, int vec) {
  constexpr int T = f32::T;
  extern __shared__ __align__(16) float smem[];
  float* cums = smem + Y_NST * Y_STAGE;       // [QP]
  float* dts = cums + QP;                     // [QP]
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5, r0 = 16 * w;
  const int gq = lane >> 2, t2 = 2 * (lane & 3);
  const int bh = blockIdx.x / npt, pt = blockIdx.x % npt, c = blockIdx.y;
  const int it = gridDim.z - 1 - blockIdx.z;
  const int b = bh / H, h = bh % H, g = h / (H / G);
  const int c0 = c * Q, len = min(Q, S - c0), i0 = it * T, p0 = pt * T;
  if (i0 >= len) return;                      // past the ragged edge
  const float* xb = x + b * x_sb + (long long)c0 * x_ss + (long long)h * P + p0;
  const float* dtb = dt + ((size_t)b * S + c0) * H + h;
  const float* cib = cm + b * c_sb + (long long)(c0 + i0) * c_ss + (long long)g * N;
  const float* sib = s_in + ((size_t)bh * nc + c) * N * P + p0;
  const float* cbb = cb + ((size_t)(b * G + g) * nc + c) * QP * QP + (size_t)i0 * QP;
  const bool inter = has_state || c > 0;      // S_in is 0 otherwise
  const int ncs = inter ? (N + H2 - 1) / H2 : 0;          // slabs of C S_in
  const int nh = min(2 * it + 2, (len + H2 - 1) / H2);    // half tiles j0 = 32 h
  const int nsteps = ncs + nh;
  auto load = [&](int s) {                    // one commit group a step, empty past the end
    if (s < nsteps) {
      float* st = smem + (s % Y_NST) * Y_STAGE;
      if (s < ncs) {
        const int k0 = s * H2;
        f32::load_tile(st, Y_LDC, cib + k0, c_ss, T, H2, len - i0, N - k0, vec, tid,
                       F_THREADS);
        f32::load_tile(st + T * Y_LDC, Y_LDS, sib + (size_t)k0 * P, P, H2, T, N - k0,
                       P - p0, (P & 3) == 0, tid, F_THREADS);
      } else {
        const int j0 = (s - ncs) * H2;
        f32::load_tile(st, Y_LDX, xb + (long long)j0 * x_ss, x_ss, H2, T, len - j0,
                       P - p0, vec, tid, F_THREADS);
        f32::load_tile(st + H2 * Y_LDX, Y_LDQ, cbb + j0, QP, T, H2, T, H2, true, tid,
                       F_THREADS);
      }
    }
    sm90::cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < Y_NST - 1; ++s) load(s);
  for (int i = tid; i < QP; i += F_THREADS) {
    cums[i] = cums_g[((size_t)bh * nc + c) * QP + i];
    dts[i] = i < len ? dtb[(size_t)i * H] : 0.f;
  }
  const int il = i0 + r0 + gq, ih = il + 8;   // this thread's rows (chunk-relative)

  float acc[8][4];
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) f32::zero(acc[nb]);
  for (int s = 0; s < nsteps; ++s) {
    sm90::cp_async_wait<Y_NST - 2>();
    __syncthreads();                          // step s (and cums) for every thread; s - 1 consumed
    load(s + Y_NST - 1);
    const float* st = smem + (s % Y_NST) * Y_STAGE;
    if (s < ncs) {
      const float* Ss = st + T * Y_LDC;
      for (int kk = 0; kk < H2 && s * H2 + kk < N; kk += 8) {
        const auto af = f32::frag_a(st, Y_LDC, r0, kk, lane);
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) mma3(acc[nb], af, f32::frag_b(Ss, Y_LDS, kk, 8 * nb, lane));
      }
      if (s == ncs - 1) {                     // the carried state is complete
        const float el = expf(cums[il]), eh = expf(cums[ih]);
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          acc[nb][0] *= el;
          acc[nb][1] *= el;
          acc[nb][2] *= eh;
          acc[nb][3] *= eh;
        }
      }
      continue;
    }
    const float* Qs = st + H2 * Y_LDX;
    const int j0 = (s - ncs) * H2;
    // the 8-column blocks this warp's rows see: j0 + 8 jj <= i0 + r0 + 15
    const int d = i0 + r0 + 15 - j0;
    const int jj_end = d < 0 ? 0 : min(4, d / 8 + 1);
    const float cl = cums[il], ch = cums[ih];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      if (jj >= jj_end) continue;
      const int ja = j0 + 8 * jj + t2, jb = ja + 1;
      const float2 ql = *reinterpret_cast<const float2*>(Qs + (r0 + gq) * Y_LDQ + 8 * jj + t2);
      const float2 qh = *reinterpret_cast<const float2*>(Qs + (r0 + gq + 8) * Y_LDQ + 8 * jj + t2);
      const float ca = cums[ja], cbv = cums[jb];
      // mask before exp: only j <= i < len is exponentiated
      const float sc[4] = {ja <= il && il < len ? ql.x * expf(cl - ca) : 0.f,
                           jb <= il && il < len ? ql.y * expf(cl - cbv) : 0.f,
                           ja <= ih && ih < len ? qh.x * expf(ch - ca) : 0.f,
                           jb <= ih && ih < len ? qh.y * expf(ch - cbv) : 0.f};
      const auto af = acc_as_a(sc);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
        mma3(acc[nb], af, f32::frag_b_perm(st, Y_LDX, 8 * jj, 8 * nb, lane, dts + j0));
    }
  }

  float* yb = y + (((size_t)b * S + c0) * H + h) * P;
  const bool pairs = (P & 1) == 0;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    const int p = p0 + 8 * nb + t2;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = hf ? ih : il;
      if (i >= len || p >= P) continue;
      float* dst = yb + (size_t)i * H * P + p;
      if (pairs) {
        *reinterpret_cast<float2*>(dst) = make_float2(acc[nb][2 * hf], acc[nb][2 * hf + 1]);
      } else {
        dst[0] = acc[nb][2 * hf];
        if (p + 1 < P) dst[1] = acc[nb][2 * hf + 1];
      }
    }
  }
}

template <int MT>
cudaError_t launch_state_mt(int bwd, int rev, const float* u, const float* v,
                            const float* dt, const float* A, const float* init,
                            float* hat, float* out, float* fin, float* cums,
                            float* last, unsigned* counters, int B, int S, int H, int G,
                            int N, int P, int Q, int QP, int nc, long long u_sb,
                            long long u_ss, long long v_sb, long long v_ss, int vec,
                            cudaStream_t stream) {
  auto* kernel = bwd ? ssd_bwd_state_kernel<MT> : ssd_state_kernel<MT>;
  const int smem = 4 * state_smem_floats(N, QP);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int npt = (P + f32::T - 1) / f32::T;
  kernel<<<dim3(B * H, nc, npt), ST_THREADS, smem, stream>>>(
      u, v, dt, A, init, hat, out, fin, cums, last, counters, rev, S, H, G, N, P, Q, QP,
      nc, npt, u_sb, u_ss, v_sb, v_ss, vec);
  return cudaGetLastError();
}


// ===========================================================================
// bfloat16: tensor cores (wgmma)
// ===========================================================================

constexpr int T = 64;                     // tile rows (wgmma M) and panel width
constexpr int WG = 128;                   // threads of a warpgroup
constexpr int T_BYTES = T * T * 2;        // one 64 x 64 bf16 tile
constexpr float LOG2E = 1.4426950408889634f;

// the first 1024-byte boundary (the swizzle atom) at or after p, a pointer
// into shared memory (pointer arithmetic keeps its address space)
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024u - (sm90::smem_addr(p) & 1023u)) & 1023u);
}

// Rows [0, R) and 16-byte chunks [0, CH) of a bf16 matrix into the sw128
// tile of R rows at base + off, by the block's nthr threads: row r is
// src + r * stride, valid if r < rows; chunk c holds columns 8c .. 8c+7,
// each valid if below cols.  Invalid elements are zero.  aligned: cp.async
// of 16 bytes (src, stride and cols are multiples of 8 elements, src
// 16-byte aligned); else one element at a time through registers.
__device__ __forceinline__ void load_tile(uint8_t* base, uint32_t off, int R,
                                          int CH, const bf16* src,
                                          long long stride, int rows, int cols,
                                          bool aligned, int tid, int nthr) {
  const uint32_t dst = sm90::smem_addr(base) + off;
  for (int e = tid; e < R * CH; e += nthr) {
    const int r = e / CH, c = e % CH;
    const uint32_t o = sm90::sw128(r, c, R);
    if (aligned) {
      const bool ok = r < rows && 8 * c < cols;
      sm90::cp_async16(dst + o, src + (ok ? r * stride + 8 * c : 0), ok);
    } else {
      const unsigned short* s16 = reinterpret_cast<const unsigned short*>(src);
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int col = 8 * c + k;
        if (r < rows && col < cols)
          w[k >> 1] |= (uint32_t)s16[r * stride + col] << (16 * (k & 1));
      }
      *reinterpret_cast<uint4*>(base + off + o) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// 2^x in one MUFU instruction (relative error ~2^-22, results below 2^-126
// flushed to 0): for the decay of scores that are rounded to bf16 next
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// accumulator fragment of a 64 x 64 wgmma tile: element i of thread
// (warp w of its warpgroup, lane l) sits at row frag_row(i), column frag_col(i)
__device__ __forceinline__ int frag_row(int i, int w, int lane) {
  return w * 16 + (lane >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int frag_col(int i, int lane) {
  return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
}

// ---------------------------------------------------------------------------
// kernel 1: cums, the chunk's own state, and the carry.  grid (B*H, nc, P
// tiles); NPT warpgroups, warpgroup w computes rows [64w, 64w + 64) of
// S^[n, p] = sum_j (B o w)[j, n] x[j, p] for one 64-column tile of P.  The
// chunk's 64-step tiles of B and x stream through a ring.  The last block
// of each (batch * head, P tile) to finish (a release-acquire ticket) then
// walks the chunks in order: S_in(0) = state_in or 0, S_in(c+1) = S_in(c)
// e^cums_c[-1] + S^_c in float32, writing each S_in as the bf16 halves
// kernel 2 reads, and the final state.
// ---------------------------------------------------------------------------
template <int NPT>   // N rounded up to 64 NPT
struct StateCfg {
  static constexpr int THREADS = WG * NPT;
  static constexpr int ST = NPT <= 2 ? 4 : 2;      // ring stages
  static constexpr int BB = NPT * T_BYTES;         // a [64 x NP] tile
  static constexpr int STAGE = BB + T_BYTES;       // B_j, then x_j
  static constexpr int OFF_HI = ST * STAGE;        // B o w halves, then floats
  static constexpr int OFF_F = OFF_HI + 2 * BB;
  static int smem(int QP) { return 1024 + OFF_F + (2 * QP + 16) * (int)sizeof(float); }
};

template <int NPT>
__global__ void __launch_bounds__(StateCfg<NPT>::THREADS)
ssd_chunk_state_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ A, const bf16* __restrict__ bm,
                       const float* __restrict__ state_in,
                       float* __restrict__ ws_cums, float* __restrict__ ws_last,
                       float* __restrict__ ws_shat, bf16* __restrict__ ws_shi,
                       bf16* __restrict__ ws_slo, float* __restrict__ state_out,
                       unsigned* __restrict__ counters, int S, int H, int G,
                       int N, int P, int Q, int QP, int nc, int npt,
                       long long x_sb, long long x_ss, long long b_sb,
                       long long b_ss, int aligned) {
  using C = StateCfg<NPT>;
  constexpr int ST = C::ST, NTHR = C::THREADS, NP = T * NPT;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  float* cums = reinterpret_cast<float*>(base + C::OFF_F);    // [QP]
  float* w = cums + QP;                                         // [QP]
  float* wsum = w + QP;                                         // [NTHR / 32]
  const uint32_t sbase = sm90::smem_addr(base);

  const int tid = threadIdx.x, wg = tid / WG, warp = (tid % WG) >> 5;
  const int lane = tid & 31, wid = tid >> 5;
  const int bh = blockIdx.x, c = blockIdx.y, pt = blockIdx.z;
  const int b = bh / H, h = bh % H, g = h / (H / G);
  const int c0 = c * Q, len = min(Q, S - c0);
  const int p0 = pt * T;
  const bf16* xb = x + b * x_sb + c0 * x_ss + (long long)h * P + p0;
  const bf16* bb = bm + b * b_sb + c0 * b_ss + (long long)g * N;
  const float* dtb = dt + ((size_t)b * S + c0) * H + h;
  const int ntiles = (len + T - 1) / T;
  // kernel 2 may launch now, on the SMs this kernel frees, and copy its
  // input tiles; it waits for this kernel's end before reading its outputs
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  auto load = [&](int jt) {
    if (jt >= ntiles) return;
    const uint32_t o = (jt % ST) * C::STAGE;
    load_tile(base, o, T, NP / 8, bb + jt * T * b_ss, b_ss, len - jt * T, N,
              aligned, tid, NTHR);
    load_tile(base, o + C::BB, T, 8, xb + jt * T * x_ss, x_ss, len - jt * T,
              P - p0, aligned, tid, NTHR);
  };
  // cums: thread t scans steps [t per, (t+1) per) (steps past len add 0)
  // and keeps their dt for w.  These loads go first, ahead of the tiles'.
  const float a = A[h];
  const int per = (QP + NTHR - 1) / NTHR;   // <= 8 (QP <= 1024)
  float dtv[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int i = tid * per + k;
    dtv[k] = k < per && i < len ? dtb[(size_t)i * H] : 0.f;
  }
#pragma unroll
  for (int jt = 0; jt < ST - 1; ++jt) {
    load(jt);
    sm90::cp_async_commit();
  }
  float loc[8];
  float run = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    run += dtv[k] * a;
    loc[k] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) wsum[wid] = incl;
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  __syncthreads();
  for (int v = 0; v < wid; ++v) excl += wsum[v];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int i = tid * per + k;
    if (k < per && i < QP) cums[i] = loc[k] + excl;
  }
  __syncthreads();
  const float last = cums[QP - 1];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int i = tid * per + k;
    if (k < per && i < QP) w[i] = dtv[k] * expf(last - cums[i]);
  }
  if (pt == 0)
    for (int i = tid; i < QP; i += NTHR) ws_cums[((size_t)bh * nc + c) * QP + i] = cums[i];
  if (tid == 0) ws_last[(size_t)bh * nc + c] = last;   // each P tile's carry reads it

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int jt = 0; jt < ntiles; ++jt) {
    const uint32_t so = (jt % ST) * C::STAGE;
    sm90::cp_async_wait<ST - 2>();
    __syncthreads();  // tile jt (and w) for every thread; tile jt-1's readers done
    load(jt + ST - 1);
    sm90::cp_async_commit();
    // B o w -> bf16 halves, at the same swizzled positions
    for (int e = tid; e < T * NP / 8; e += NTHR) {
      const int r = e / (NP / 8);
      const uint32_t o = sm90::sw128(r, e % (NP / 8), T);
      const float wr = w[jt * T + r];
      const uint4 v = *reinterpret_cast<const uint4*>(base + so + o);
      const uint32_t in[4] = {v.x, v.y, v.z, v.w};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = unpack_bf16(in[q]);
        const float f0 = f.x * wr, f1 = f.y * wr;
        hi[q] = sm90::pack_bf16(f0, f1);
        const float2 hf = unpack_bf16(hi[q]);
        lo[q] = sm90::pack_bf16(f0 - hf.x, f1 - hf.y);
      }
      *reinterpret_cast<uint4*>(base + C::OFF_HI + o) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(base + C::OFF_HI + C::BB + o) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    sm90::fence_async_shared();
    __syncthreads();
    // this warpgroup's panel of the halves: n in [64 wg, 64 wg + 64)
    const uint32_t sa = sbase + C::OFF_HI + wg * T_BYTES;
    const uint32_t sx = sbase + so + C::BB;
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < T / 16; ++kk) {
      const uint64_t db = sm90::desc_sw128(sx + kk * 2048, T * 128, 1024);
      sm90::wgmma_ss_n64<1, 1>(acc, sm90::desc_sw128(sa + kk * 2048, T * 128, 1024), db, 1);
      sm90::wgmma_ss_n64<1, 1>(
          acc, sm90::desc_sw128(sa + C::BB + kk * 2048, T * 128, 1024), db, 1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
  }
  // S^ through shared memory (the ring is free), then out in rows of 16
  // bytes where P allows (P % 4 == 0), so the stores are whole lines
  constexpr int SROW = T + 8;                  // floats a staged row (fewer bank conflicts)
  static_assert(NP * SROW * 4 <= C::OFF_HI, "the staged S^ fits in the ring");
  float* stage = reinterpret_cast<float*>(base);
  __syncthreads();                             // every warpgroup is done with the ring
#pragma unroll
  for (int i = 0; i < 32; i += 2)
    *reinterpret_cast<float2*>(stage + (wg * T + frag_row(i, warp, lane)) * SROW +
                               frag_col(i, lane)) = make_float2(acc[i], acc[i + 1]);
  __syncthreads();
  const bool vec = (P & 3) == 0;
  float* out = ws_shat + ((size_t)bh * nc + c) * N * P;
  for (int e = tid; e < NP * (T / 4); e += NTHR) {
    const int n = e / (T / 4), p = p0 + 4 * (e % (T / 4));
    if (n >= N || p >= P) continue;
    const float* v = stage + n * SROW + (p - p0);
    if (vec) {
      *reinterpret_cast<float4*>(out + (size_t)n * P + p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      for (int k = 0; k < 4 && p + k < P; ++k) out[(size_t)n * P + p + k] = v[k];
    }
  }

  // the carry, by the last block of this (batch * head, P tile).  The
  // barrier orders the block's S^ before thread 0's ticket, whose release
  // makes it visible at gpu scope; the last ticket's acquire, and the
  // barrier after it, order the other chunks' S^ before the carry's loads
  // (which bypass L1).
  __syncthreads();
  unsigned ticket = 0;
  unsigned* counter = counters + (size_t)bh * npt + pt;
  if (tid == 0) ticket = sm90::atomic_add_acq_rel(counter, 1u);
  if (!__syncthreads_or(tid == 0 && ticket == (unsigned)nc - 1)) return;
  // thread tid owns the groups of 4 columns g = tid + NTHR k of the [NP, 64]
  // tile (8 of them, coalesced); chunk cc + 1's loads are in flight during
  // chunk cc's stores
  constexpr int GPT = NP * (T / 4) / NTHR;     // = 8
  float4 sv[GPT], add[GPT];
  auto col4 = [&](const float* m, int k, bool v4) {   // 4 columns of [N, P] m
    const int g = tid + k * NTHR, n = g / (T / 4), p = p0 + 4 * (g % (T / 4));
    if (n >= N || p >= P) return make_float4(0.f, 0.f, 0.f, 0.f);
    const float* src = m + (size_t)n * P + p;
    if (v4) return __ldcg(reinterpret_cast<const float4*>(src));
    float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
    r.x = __ldcg(src);
    if (p + 1 < P) r.y = __ldcg(src + 1);
    if (p + 2 < P) r.z = __ldcg(src + 2);
    if (p + 3 < P) r.w = __ldcg(src + 3);
    return r;
  };
#pragma unroll
  for (int k = 0; k < GPT; ++k) {
    add[k] = col4(ws_shat + (size_t)bh * nc * N * P, k, vec);
    sv[k] = state_in != nullptr
                ? col4(state_in + (size_t)bh * N * P, k,
                       vec && (reinterpret_cast<uintptr_t>(state_in) & 15) == 0)
                : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float last_c = __ldcg(ws_last + (size_t)bh * nc);
  for (int cc = 0; cc < nc; ++cc) {
    float4 nxt[GPT];
#pragma unroll
    for (int k = 0; k < GPT; ++k)
      nxt[k] = cc + 1 < nc ? col4(ws_shat + ((size_t)bh * nc + cc + 1) * N * P, k, vec)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    const float last_n = cc + 1 < nc ? __ldcg(ws_last + (size_t)bh * nc + cc + 1) : 0.f;
    const float decay = expf(last_c);
    const size_t o = (((size_t)bh * nc + cc) * npt + pt) * NP * T;
    // kernel 2 reads chunk 0's S_in only when it is state_in
    const bool write = cc > 0 || state_in != nullptr;
#pragma unroll
    for (int k = 0; k < GPT; ++k) {
      const int e = 4 * (tid + k * NTHR);
      const float4 v = sv[k];
      if (write) {
        const uint32_t h0 = sm90::pack_bf16(v.x, v.y), h1 = sm90::pack_bf16(v.z, v.w);
        const float2 f0 = unpack_bf16(h0), f1 = unpack_bf16(h1);
        *reinterpret_cast<uint2*>(ws_shi + o + e) = make_uint2(h0, h1);
        *reinterpret_cast<uint2*>(ws_slo + o + e) = make_uint2(
            sm90::pack_bf16(v.x - f0.x, v.y - f0.y), sm90::pack_bf16(v.z - f1.x, v.w - f1.y));
      }
      sv[k] = make_float4(v.x * decay + add[k].x, v.y * decay + add[k].y,
                          v.z * decay + add[k].z, v.w * decay + add[k].w);
      add[k] = nxt[k];
    }
    last_c = last_n;
  }
  if (state_out != nullptr) {
#pragma unroll
    for (int k = 0; k < GPT; ++k) {
      const int g = tid + k * NTHR, n = g / (T / 4), p = p0 + 4 * (g % (T / 4));
      if (n >= N || p >= P) continue;
      float* dst = state_out + ((size_t)bh * N + n) * P + p;
      if (vec) {
        *reinterpret_cast<float4*>(dst) = sv[k];
      } else {
        dst[0] = sv[k].x;
        if (p + 1 < P) dst[1] = sv[k].y;
        if (p + 2 < P) dst[2] = sv[k].z;
        if (p + 3 < P) dst[3] = sv[k].w;
      }
    }
  }
  if (tid == 0) *counter = 0u;
}

// ---------------------------------------------------------------------------
// kernel 2: y.  grid (B*H*npt, nc, row groups); a block owns WGS 64-row
// tiles of one chunk (one warpgroup each) and 64 columns of P.  The block
// loads each (B_j, x_j) tile once, through a ring of ScanCfg::ST stages
// (at Q = 256 all four are in flight at once), for all its warpgroups;
// warpgroup w uses the tiles j <= its row tile.
// ---------------------------------------------------------------------------
template <int NPT>   // N rounded up to 64 NPT
struct ScanCfg {
  static constexpr int NP = T * NPT;
  static constexpr int KN = NP / 16;               // k-steps over N
  static constexpr int WGS = NPT <= 3 ? 4 : 2;     // row tiles a block
  static constexpr int THREADS = WG * WGS;
  static constexpr int NB = NP * 128;              // a [64 x NP] or [NP x 64] tile
  static constexpr int ST = NPT <= 2 ? 4 : 2;      // ring stages
  static constexpr int STAGE = NB + T_BYTES;       // B_j, then x_j
  static constexpr int OFF_S = WGS * NB;           // after the C tiles: S_in hi, lo
  static constexpr int OFF_RING = OFF_S + 2 * NB;
  static constexpr int OFF_F = OFF_RING + ST * STAGE;  // cums, dt
  static int smem(int QP) { return 1024 + OFF_F + 2 * QP * (int)sizeof(float); }
};

template <int NPT>
__global__ void __launch_bounds__(ScanCfg<NPT>::THREADS)
ssd_chunk_scan_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                      const bf16* __restrict__ bm, const bf16* __restrict__ cm,
                      const float* __restrict__ ws_cums,
                      const bf16* __restrict__ ws_shi,
                      const bf16* __restrict__ ws_slo, bf16* __restrict__ y,
                      int S, int H, int G, int N, int P, int Q, int QP, int nc,
                      int npt, int has_state, long long x_sb, long long x_ss,
                      long long b_sb, long long b_ss, long long c_sb,
                      long long c_ss, int aligned) {
  using C = ScanCfg<NPT>;
  constexpr int NP = C::NP, NB = C::NB, NTHR = C::THREADS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  const uint32_t sbase = sm90::smem_addr(base);
  float* cums = reinterpret_cast<float*>(base + C::OFF_F);   // log2(e) cums
  float* dts = cums + QP;

  const int tid = threadIdx.x, wg = tid / WG, warp = (tid % WG) >> 5, lane = tid & 31;
  const int bh = blockIdx.x / npt, pt = blockIdx.x % npt;
  const int c = blockIdx.y;
  const int rg = gridDim.z - 1 - blockIdx.z;   // the longest row groups first
  const int b = bh / H, h = bh % H, g = h / (H / G);
  const int c0 = c * Q, len = min(Q, S - c0);
  const int ntl = (len + T - 1) / T;           // live 64-row tiles
  const int it0 = rg * C::WGS;
  if (it0 >= ntl) return;                      // past the ragged edge
  const int it_end = min(it0 + C::WGS, ntl);   // this block's row tiles
  const int it = it0 + wg;                     // this warpgroup's
  const bool live = it < it_end;
  const int i0 = it * T, p0 = pt * T;
  const bool inter = has_state || c > 0;       // S_in is 0 otherwise
  const bf16* xb = x + b * x_sb + c0 * x_ss + (long long)h * P + p0;
  const bf16* bb = bm + b * b_sb + c0 * b_ss + (long long)g * N;
  const bf16* cb = cm + b * c_sb + c0 * c_ss + (long long)g * N;
  const float* dtb = dt + ((size_t)b * S + c0) * H + h;

  auto load = [&](int jt) {
    if (jt >= it_end) return;
    const uint32_t o = C::OFF_RING + (jt % C::ST) * C::STAGE;
    load_tile(base, o, T, NP / 8, bb + jt * T * b_ss, b_ss, len - jt * T, N,
              aligned, tid, NTHR);
    load_tile(base, o + NB, T, 8, xb + jt * T * x_ss, x_ss, len - jt * T,
              P - p0, aligned, tid, NTHR);
  };
  // The inputs' tiles first: C and the ring's first ST - 1 (B_j, x_j), one
  // commit group per ring stage.  They do not depend on kernel 1, which may
  // still be running (programmatic dependent launch): griddepcontrol.wait
  // then waits for it before its outputs (cums, S_in) are read.  S_in joins
  // the last prologue group; the carried-state term, which alone needs it,
  // runs after the loop.
  for (int t = it0; t < it_end; ++t)
    load_tile(base, (t - it0) * NB, T, NP / 8, cb + t * T * c_ss, c_ss,
              len - t * T, N, aligned, tid, NTHR);
#pragma unroll
  for (int jt = 0; jt < C::ST - 1; ++jt) {
    load(jt);
    if (jt == C::ST - 2) {
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
      if (inter) {
        const size_t so = (((size_t)bh * nc + c) * npt + pt) * NP * T;
        load_tile(base, C::OFF_S, NP, 8, ws_shi + so, T, NP, T, true, tid, NTHR);
        load_tile(base, C::OFF_S + NB, NP, 8, ws_slo + so, T, NP, T, true, tid, NTHR);
      }
    }
    sm90::cp_async_commit();
  }
  const float* cw = ws_cums + ((size_t)bh * nc + c) * QP;
  for (int j = tid; j < it_end * T; j += NTHR) {
    cums[j] = cw[j] * LOG2E;                   // exp2 units
    dts[j] = j < len ? dtb[(size_t)j * H] : 0.f;
  }

  const uint32_t sC = sbase + wg * NB;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int jt = 0; jt < it_end; ++jt) {
    sm90::cp_async_wait<C::ST - 2>();
    sm90::fence_async_shared();
    __syncthreads();  // tile jt (C, cums) for every thread; jt-1 done
    load(jt + C::ST - 1);
    sm90::cp_async_commit();
    if (!live || jt > it) continue;            // above this warpgroup's diagonal

    // scores C B_j^T
    const uint32_t sB = sbase + C::OFF_RING + (jt % C::ST) * C::STAGE;
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    sm90::fence_regs(sc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::KN; ++kk) {
      const uint32_t ko = (kk >> 2) * (T * 128) + (kk & 3) * 32;
      sm90::wgmma_ss_n64<0, 0>(sc, sm90::desc_sw128(sC + ko, 16, 1024),
                                 sm90::desc_sw128(sB + ko, 16, 1024), kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);

    // o L o dt_j, masked before exp; bf16 A fragments (k-step kk: 8kk..8kk+7).
    // This thread's elements lie in 2 rows and 16 columns.
    const int j0 = jt * T;
    const bool diag = jt == it;
    const int r0 = i0 + frag_row(0, warp, lane), r1 = r0 + 8;
    const float cr0 = cums[r0], cr1 = cums[r1];
    uint32_t pa[T / 16][4];
#pragma unroll
    for (int i = 0; i < 32; i += 4) {    // columns q, q + 1 of rows r0, r1
      const int q = j0 + frag_col(i, lane);
      const float cq0 = cums[q], cq1 = cums[q + 1];
      const float d0 = dts[q], d1 = dts[q + 1];
      const float v0 = (!diag || q <= r0) ? sc[i] * exp2_approx(cr0 - cq0) * d0 : 0.f;
      const float v1 = (!diag || q + 1 <= r0) ? sc[i + 1] * exp2_approx(cr0 - cq1) * d1 : 0.f;
      const float v2 = (!diag || q <= r1) ? sc[i + 2] * exp2_approx(cr1 - cq0) * d0 : 0.f;
      const float v3 = (!diag || q + 1 <= r1) ? sc[i + 3] * exp2_approx(cr1 - cq1) * d1 : 0.f;
      pa[i >> 3][(i >> 1) & 3] = sm90::pack_bf16(v0, v1);
      pa[i >> 3][((i >> 1) & 3) + 1] = sm90::pack_bf16(v2, v3);
    }
    const uint32_t sx = sB + NB;
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < T / 16; ++kk)
      sm90::wgmma_rs_n64_tb(acc, pa[kk], sm90::desc_sw128(sx + kk * 2048, T * 128, 1024), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
  }

  if (inter) {
    // carried state: y += e^cums_i (C S_in)_i, S_in = hi + lo
    sm90::cp_async_wait<0>();
    sm90::fence_async_shared();
    __syncthreads();  // S_in for every thread
    if (live) {
      float d[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) d[i] = 0.f;
      sm90::fence_regs(d);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::KN; ++kk) {
        const uint64_t da = sm90::desc_sw128(
            sC + (kk >> 2) * (T * 128) + (kk & 3) * 32, 16, 1024);
        sm90::wgmma_ss_n64<0, 1>(
            d, da, sm90::desc_sw128(sbase + C::OFF_S + kk * 2048, NB, 1024), 1);
        sm90::wgmma_ss_n64<0, 1>(
            d, da, sm90::desc_sw128(sbase + C::OFF_S + NB + kk * 2048, NB, 1024), 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(d);
      const float e0 = exp2f(cums[i0 + frag_row(0, warp, lane)]);
      const float e1 = exp2f(cums[i0 + frag_row(2, warp, lane)]);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] += d[i] * ((i & 2) ? e1 : e0);
    }
  }
  if (!live) return;

  bf16* yb = y + ((size_t)b * S + c0) * H * P + (size_t)h * P;
  const bool pairs = (P & 1) == 0;
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int r = i0 + frag_row(i, warp, lane), p = p0 + frag_col(i, lane);
    if (r >= len) continue;
    bf16* dst = yb + (size_t)r * H * P + p;
    if (pairs && p + 1 < P) {
      *reinterpret_cast<uint32_t*>(dst) = sm90::pack_bf16(acc[i], acc[i + 1]);
    } else {
      if (p < P) dst[0] = __float2bfloat16_rn(acc[i]);
      if (p + 1 < P) dst[1] = __float2bfloat16_rn(acc[i + 1]);
    }
  }
}

template <int NPT>
cudaError_t launch_nt(const bf16* x, const float* dt, const float* A,
                      const bf16* bm, const bf16* cm, const float* state_in,
                      bf16* y, float* state_out, float* ws_cums, float* ws_last,
                      float* ws_shat, bf16* ws_shi, bf16* ws_slo,
                      unsigned* counters, int B, int S, int H, int G, int N,
                      int P, int Q, long long x_sb, long long x_ss,
                      long long b_sb, long long b_ss, long long c_sb,
                      long long c_ss, int aligned, cudaStream_t stream) {
  const int nc = (S + Q - 1) / Q, QP = (Q + T - 1) / T * T;
  const int npt = (P + T - 1) / T;
  const int smem1 = StateCfg<NPT>::smem(QP);
  cudaError_t err = set_smem(ssd_chunk_state_kernel<NPT>, smem1);
  if (err != cudaSuccess) return err;
  ssd_chunk_state_kernel<NPT><<<dim3(B * H, nc, npt), StateCfg<NPT>::THREADS, smem1, stream>>>(
      x, dt, A, bm, state_in, ws_cums, ws_last, ws_shat, ws_shi, ws_slo,
      state_out, counters, S, H, G, N, P, Q, QP, nc, npt, x_sb, x_ss, b_sb,
      b_ss, aligned);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  using C = ScanCfg<NPT>;
  const int smem2 = C::smem(QP);
  err = set_smem(ssd_chunk_scan_kernel<NPT>, smem2);
  if (err != cudaSuccess) return err;
  // a programmatic dependent launch: see griddepcontrol in the kernels
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * H * npt, nc, (QP / T + C::WGS - 1) / C::WGS);
  cfg.blockDim = dim3(C::THREADS);
  cfg.dynamicSmemBytes = smem2;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, ssd_chunk_scan_kernel<NPT>, x, dt, bm, cm,
                            (const float*)ws_cums, (const bf16*)ws_shi,
                            (const bf16*)ws_slo, y, S, H, G, N, P, Q, QP, nc,
                            npt, (int)(state_in != nullptr), x_sb, x_ss, b_sb,
                            b_ss, c_sb, c_ss, aligned);
}


cudaError_t launch_tc(const bf16* x, const float* dt, const float* A,
                      const bf16* bm, const bf16* cm, const float* state_in,
                      bf16* y, float* state_out, float* ws_cums, float* ws_last,
                      float* ws_shat, bf16* ws_shi, bf16* ws_slo,
                      unsigned* counters, int B, int S, int H, int G, int N,
                      int P, int Q, long long x_sb, long long x_ss,
                      long long b_sb, long long b_ss, long long c_sb,
                      long long c_ss, cudaStream_t stream) {
  const int aligned = aligned16(x) && aligned16(bm) && aligned16(cm) &&
                      N % 8 == 0 && P % 8 == 0 && x_sb % 8 == 0 &&
                      x_ss % 8 == 0 && b_sb % 8 == 0 && b_ss % 8 == 0 &&
                      c_sb % 8 == 0 && c_ss % 8 == 0;
  switch ((N + T - 1) / T) {
#define LAUNCH(n) case n: return launch_nt<n>(x, dt, A, bm, cm, state_in, y, state_out, ws_cums, ws_last, ws_shat, ws_shi, ws_slo, counters, B, S, H, G, N, P, Q, x_sb, x_ss, b_sb, b_ss, c_sb, c_ss, aligned, stream)
    LAUNCH(1); LAUNCH(2); LAUNCH(3); LAUNCH(4);
#undef LAUNCH
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_f32(const float* x, const float* dt, const float* A,
                       const float* bm, const float* cm, const float* state_in,
                       float* y, float* state_out, float* ws_cb, float* ws_cums,
                       float* ws_last, float* ws_states, unsigned* counters, int B,
                       int S, int H, int G, int N, int P, int Q, long long x_sb, long long x_ss, long long b_sb,
                       long long b_ss, long long c_sb, long long c_ss,
                       cudaStream_t stream) {
  const int nc = (S + Q - 1) / Q, QP = round_up(Q, f32::T);
  const int npt = (P + f32::T - 1) / f32::T;
  const int vec = aligned16(x) && aligned16(bm) && aligned16(cm) && N % 4 == 0 &&
                  P % 4 == 0 && x_sb % 4 == 0 && x_ss % 4 == 0 && b_sb % 4 == 0 &&
                  b_ss % 4 == 0 && c_sb % 4 == 0 && c_ss % 4 == 0;
  cudaError_t err = f32::launch_cb(0, bm, cm, ws_cb, B, S, G, N, Q, QP, nc, b_sb,
                                   b_ss, c_sb, c_ss, vec, stream);
  if (err != cudaSuccess) return err;
  err = f32::launch_state(0, 0, bm, x, dt, A, state_in, ws_states, ws_states, state_out, ws_cums,
                          ws_last, counters, B, S, H, G, N, P, Q, QP, nc, b_sb, b_ss,
                          x_sb, x_ss, vec, stream);
  if (err != cudaSuccess) return err;
  const int smem = 4 * (Y_NST * Y_STAGE + 2 * QP);
  err = set_smem(ssd_y_kernel, smem);
  if (err != cudaSuccess) return err;
  ssd_y_kernel<<<dim3(B * H * npt, nc, QP / f32::T), F_THREADS, smem, stream>>>(
      x, dt, cm, ws_cb, ws_cums, ws_states, y, S, H, G, N, P, Q, QP, nc, npt,
      (int)(state_in != nullptr), x_sb, x_ss, c_sb, c_ss, vec);
  return cudaGetLastError();
}

}  // namespace

namespace repro_torch {
namespace ssd_f32 {

cudaError_t launch_cb(int bwd, const float* bm, const float* cm, float* cb, int B,
                      int S, int G, int N, int Q, int QP, int nc, long long b_sb,
                      long long b_ss, long long c_sb, long long c_ss, int vec,
                      cudaStream_t stream) {
  const int nt = QP / T, smem = 4 * 2 * T * ld4(round_up(N, 8));
  auto* kernel = bwd ? ssd_bwd_cb_kernel : ssd_cb_kernel;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(nt * (nt + 1) / 2, nc, B * G), F_THREADS, smem, stream>>>(
      bm, cm, cb, S, G, N, Q, QP, nc, b_sb, b_ss, c_sb, c_ss, vec);
  return cudaGetLastError();
}

cudaError_t launch_state(int bwd, int rev, const float* u, const float* v,
                         const float* dt, const float* A, const float* init, float* hat,
                         float* out, float* fin, float* cums, float* last,
                         unsigned* counters, int B, int S, int H, int G, int N, int P,
                         int Q, int QP, int nc, long long u_sb, long long u_ss,
                         long long v_sb, long long v_ss, int vec, cudaStream_t stream) {
  return N > 128 ? launch_state_mt<2>(bwd, rev, u, v, dt, A, init, hat, out, fin, cums,
                                      last, counters, B, S, H, G, N, P, Q, QP, nc, u_sb,
                                      u_ss, v_sb, v_ss, vec, stream)
                 : launch_state_mt<1>(bwd, rev, u, v, dt, A, init, hat, out, fin, cums,
                                      last, counters, B, S, H, G, N, P, Q, QP, nc, u_sb,
                                      u_ss, v_sb, v_ss, vec, stream);
}

}  // namespace ssd_f32
}  // namespace repro_torch



// x [B,S,H,P] and bm, cm [B,S,G,N] (is_bf16: 1 bfloat16, 0 float32), each
// with its last two dims contiguous and the given strides (in elements)
// between batch rows (*_sb) and positions (*_ss); dt [B,S,H] and A [H]
// float32; state_in (or null) and state_out (or null) [B,H,N,P] float32; y
// [B,S,H,P] contiguous.  Workspaces (nc = ceil(S / Q), QP and NP = Q and N
// rounded up to 64, npt = ceil(P / 64)): bfloat16 ws0 = cums [B*H, nc, QP]
// f32, ws1 = cums[-1] [B*H, nc] f32, ws2 = chunk states [B*H, nc, N, P] f32,
// ws3 / ws4 = S_in's bf16 halves [B*H, nc, npt, NP, 64]; float32 ws0 = C B^T
// [B*G, nc, QP, QP], ws1 = cums [B*H, nc, QP], ws2 = cums[-1] [B*H, nc], ws3
// = S_in [B*H, nc, N, P] (written over the chunk states), ws4 unused (may
// be null); ws5 = B*H*npt unsigned ticket
// counters, zero before the call and left at zero.  Returns the cudaError_t
// of the launches (0 on success).
extern "C" int ssd_chunk_fwd(const void* x, const void* dt, const void* A,
                             const void* bm, const void* cm,
                             const void* state_in, void* y, void* state_out,
                             void* ws0, void* ws1, void* ws2, void* ws3,
                             void* ws4, void* ws5, int is_bf16, int B, int S,
                             int H, int G, int N, int P, int Q, long long x_sb,
                             long long x_ss, long long b_sb, long long b_ss,
                             long long c_sb, long long c_ss, void* stream) {
  if (B <= 0 || S <= 0 || G <= 0 || H % G != 0 || N <= 0 || N > 256 ||
      P <= 0 || Q <= 0 || Q > S || Q > 1024)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A);
  const float* s_in = static_cast<const float*>(state_in);
  float* sout = static_cast<float*>(state_out);
  unsigned* counters = static_cast<unsigned*>(ws5);
  if (is_bf16)
    return launch_tc(static_cast<const bf16*>(x), dtf, af,
                     static_cast<const bf16*>(bm), static_cast<const bf16*>(cm),
                     s_in, static_cast<bf16*>(y), sout,
                     static_cast<float*>(ws0), static_cast<float*>(ws1),
                     static_cast<float*>(ws2), static_cast<bf16*>(ws3),
                     static_cast<bf16*>(ws4), counters, B, S, H,
                     G, N, P, Q, x_sb, x_ss, b_sb, b_ss, c_sb, c_ss, st);
  return launch_f32(static_cast<const float*>(x), dtf, af,
                    static_cast<const float*>(bm), static_cast<const float*>(cm),
                    s_in, static_cast<float*>(y), sout, static_cast<float*>(ws0),
                    static_cast<float*>(ws1), static_cast<float*>(ws2),
                    static_cast<float*>(ws3), counters,
                    B, S, H, G, N, P, Q, x_sb, x_ss, b_sb, b_ss, c_sb, c_ss, st);
}
