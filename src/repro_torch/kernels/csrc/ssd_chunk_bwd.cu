// The backward of the Mamba-2 SSD chunk scan for Hopper (sm_90a), float32.
//
// Replaces no TPU kernel: the reference differentiates its XLA path,
// src/repro/models/mamba2.py::ssd_chunked, and the Pallas kernel
// src/repro/kernels/ssd_chunk.py has no backward.  It computes the VJP of
// the chunked SSD that csrc/ssd_chunk.cu computes forward (the formulas are
// written out in kernels/ssd_chunk.py::ssd_bwd_plain).  Per chunk of Q
// steps of one (batch, head), with cums_i = sum_{k<=i} dt_k A,
// xbar_j = dt_j x_j, E_ij = e^(cums_i - cums_j) for j <= i (else 0),
// W = (C B^T) o E, G = dy xbar^T, Z = G o E, R = W o G, S_in the state
// carried into the chunk and dS_out the cotangent of the state it hands on:
//   dxbar_j = sum_i W_ij dy_i + e^(last - cums_j) dS_out^T B_j
//   dB_j    = sum_i Z_ij C_i  + e^(last - cums_j) dS_out xbar_j
//   dC_i    = sum_j Z_ij B_j  + e^cums_i S_in dy_i
//   dcums_i = sum_j R_ij - sum_j R_ji + e^cums_i C_i . (S_in dy_i) - v_i,
//             v_j = e^(last - cums_j) B_j . (dS_out xbar_j),
//             plus sum_j v_j + e^last <S_in, dS_out> at the last row
//   dS_in   = e^last dS_out + sum_i e^cums_i C_i dy_i^T   (the reverse carry)
// then d(dtA) = the reverse cumsum of dcums, ddt = A d(dtA) + x . dxbar,
// dx = dt dxbar, dA = sum dt d(dtA); dB and dC sum over each group's heads.
//
// What bounds it on the H100: operations.  At Mamba-2's training shape
// (B=2, S=512, H=64, P=64, G=1, N=128, Q=256, no state_in, no dS_final) the
// function needs 9.19 GFLOP of float32-accurate products: 56 us as 3xTF32
// on the tensor cores (495 TFLOP/s), against 53 MB moved (16 us).  Every
// product runs there, as mma.sync.m16n8k8 TF32 in tf32x3.cuh's 3xTF32
// split (one TF32 product misses the 1e-4 tolerance; wgmma takes TF32 only
// K-major from shared memory, and these products read B, C, x and dy both
// ways), from shared tiles laid out for the orientation each fragment
// reads (ssd_f32.cuh).
// The products done there are 1.17x what the function needs (counted in
// tests/test_torch_ssd_plan.py): whole 8-column blocks on the diagonal
// tiles, and G computed by both pair passes; state terms that a zero S_in
// or dS_out makes vanish are skipped, and so is the product of a chunk
// whose own state no carry reads (the last forward, the first reversed
// unless d state_in is wanted).  Seven launches:
//  1. ssd_bwd_cb_kernel (the forward's ssd_cb_kernel under a name of its
//     own, ssd_chunk.cu): C B^T once per (batch, group, chunk) on the tiles
//     on and below the diagonal, into scratch (in L2);
//  2. ssd_bwd_state_kernel forward (the forward's state pass, ssd_chunk.cu):
//     per (batch * head, chunk, P tile) cums and the chunk's own state, then
//     S_in per chunk by the carry of the last block to finish (the forward
//     saves nothing: S_in is recomputed);
//  3. ssd_bwd_state_kernel reversed: dS^_c = (C o e^cums)^T dy per chunk,
//     then dS_out per chunk from dS_final (or 0) down to d state_in;
//  4. ssd_bwd_col_kernel, one block per (batch * head, chunk, 64-row tile
//     J), tile 0 (the most pairs) first: the dS_out terms, then for every
//     half tile of I >= J the tile of G^T = xbar_J dy_I^T and W^T, Z^T (C B^T
//     read from scratch), then dxbar_J += W^T dy_I, dB_J += Z^T C_I and R's
//     column sums; dx, x . dxbar, v and dB per head;
//  5. ssd_bwd_row_kernel, one block per (batch * head, chunk, tile I), the
//     last tile first: the S_in term, then for every half tile of J <= I the
//     tile of G = dy_I xbar_J^T and Z, dC_I += Z B_J and R's row sums;
//  6. ssd_bwd_finish_kernel, one block per (batch * head, chunk): dcums, its
//     reverse cumsum (a warp scan), ddt and the chunk's part of dA;
//  7. ssd_bwd_sum_kernel: dB and dC over each group's heads in the order
//     h = g rep .. g rep + rep - 1, and dA over (batch, chunk) in order.
// A pass block's accumulators live in registers (warp w owns 16 rows of its
// tile and every output column), so two blocks share an SM; an output of
// more than 128 columns of N (or 64 of P) is taken in sweeps, each
// recomputing G.  No float atomics: every sum is taken in a fixed order, so
// two calls give the same bits.
//
// Layout: as the forward.  x [B, S, H, P] and B/C [B, S, G, N] with their
// last two dims contiguous and any stride between batch rows and positions;
// dt, dy, the states and every output contiguous float32.  The ragged S
// edge is masked: positions past S have dt = 0 in the forward's padding, so
// the padded rows add nothing but the last row's carry terms, which are
// added to every position of the chunk.

#include <stdint.h>

#include <cuda_runtime.h>

#include "sm90.cuh"
#include "ssd_f32.cuh"
#include "tf32x3.cuh"

namespace {

namespace sm90 = repro_torch::sm90;
namespace f32 = repro_torch::ssd_f32;
using f32::H2;
using f32::ld4;
using f32::ld8;
using f32::round_up;
using f32::T;
using repro_torch::tf32x3::acc_as_a;
using repro_torch::tf32x3::mma3;

constexpr int THREADS = 128;   // the pair passes: four warps, 16 rows each
constexpr int PPASS = 64;      // columns of dxbar a column-pass sweep accumulates
constexpr int NST = 2;         // the pair passes' ring stages

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// the sum of v over the four lanes of a quad (one accumulator row), in a
// fixed order; every lane of the quad gets the same bits
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---------------------------------------------------------------------------
// Shared-memory plans of the pair passes (floats).  NW = 8 NB columns of N
// a sweep.
// Column pass: x_J [64][PW] (PW = P rounded up to 64); a region holding
// first B_J [64][NR] and dS_out [NR][PW] (NR = N rounded up to NW), then NST
// stages of {dy_I half [32][PW], C_I half [32][NW], (C B^T) half [32 i][64
// j]}; cums, dt and e^(last - cums) [QP] each.
// Row pass: dy_I [64][PK] (PK = P rounded up to 8); a region holding first
// S_in rows [NW][PK] and C_I [64][NW], then NST stages of {x_J half
// [32][PK], B_J half [32][NW], (C B^T) half [64 i][32 j]}; cums, dt [QP].
// ---------------------------------------------------------------------------
struct ColPlan {
  int PW, ldx, NR, ldb, stage, region, total;
  __host__ __device__ ColPlan(int N, int P, int NW, int QP) {
    PW = round_up(P, PPASS);
    ldx = ld4(PW);
    NR = round_up(N, NW);
    ldb = ld4(NR);
    stage = H2 * (ldx + ld4(NW) + ld4(T));
    const int start = T * ldb + NR * ldx;
    region = start > NST * stage ? start : NST * stage;
    total = T * ldx + region + 3 * QP;
  }
};

struct RowPlan {
  int PK, ldp, stage, region, total;
  __host__ __device__ RowPlan(int P, int NW, int QP) {
    PK = round_up(P, 8);
    ldp = ld4(PK);
    stage = H2 * ldp + H2 * ld4(NW) + T * ld8(H2);
    const int start = NW * ldp + T * ld4(NW);
    region = start > NST * stage ? start : NST * stage;
    total = T * ldp + region + 2 * QP;
  }
};

// ---------------------------------------------------------------------------
// 4. The column pass, grid (B * H, nc, QP / 64): tile J = blockIdx.z of the
// chunk (tile 0 walks the most pairs and launches first).  Warp w owns the
// rows j0 + 16 w .. + 15 of J; its accumulators: dxbar [16][64 of P] and dB
// [16][NW].
// ---------------------------------------------------------------------------
template <int NB>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_col_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ bm, const float* __restrict__ cm,
                   const float* __restrict__ dy, const float* __restrict__ cums_g,
                   const float* __restrict__ cb, const float* __restrict__ ds_out,
                   float* __restrict__ dx, float* __restrict__ dbh,
                   float* __restrict__ colpart, float* __restrict__ vout,
                   float* __restrict__ xdx, int S, int H, int G, int N, int P, int Q,
                   int QP, int nc, int has_ds, long long x_sb, long long x_ss,
                   long long b_sb, long long b_ss, long long c_sb, long long c_ss,
                   int vec) {
  constexpr int NW = 8 * NB, LDN = ld4(NW), LDQ = ld4(T);
  const ColPlan L(N, P, NW, QP);
  const int ldx = L.ldx, ldb = L.ldb;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                          // x_J [64][ldx]
  float* reg = xs + T * ldx;                 // B_J and dS_out, then the stages
  float* cums = reg + L.region;              // [QP]
  float* dts = cums + QP;                    // [QP]
  float* wts = dts + QP;                     // [QP] e^(last - cums_j)
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5, r0 = 16 * w;
  const int gq = lane >> 2, t2 = 2 * (lane & 3);
  const int bh = blockIdx.x, c = blockIdx.y, jt = blockIdx.z;
  const int b = bh / H, h = bh % H, g = h / (H / G);
  const int c0 = c * Q, len = min(Q, S - c0), j0 = jt * T;
  if (j0 >= len) return;                     // past the ragged edge
  const long long dy_ss = (long long)H * P;
  const float* xb = x + b * x_sb + (long long)c0 * x_ss + (long long)h * P;
  const float* bb = bm + b * b_sb + (long long)c0 * b_ss + (long long)g * N;
  const float* cmb = cm + b * c_sb + (long long)c0 * c_ss + (long long)g * N;
  const float* dyb = dy + ((size_t)b * S + c0) * H * P + (size_t)h * P;
  const float* dtb = dt + ((size_t)b * S + c0) * H + h;
  const float* cbb = cb + ((size_t)(b * G + g) * nc + c) * QP * QP + j0;
  const float* dso = ds_out + ((size_t)bh * nc + c) * N * P;
  const bool vdy = (P & 3) == 0;             // dy and dS_out: contiguous
  const size_t crow = ((size_t)bh * nc + c) * QP;
  // dS_out is 0 in the last chunk when no final-state cotangent is given
  const bool ds_terms = has_ds || c < nc - 1;

  f32::load_tile(xs, ldx, xb + (long long)j0 * x_ss, x_ss, T, L.PW, len - j0, P, vec,
                 tid, THREADS);
  sm90::cp_async_commit();
  const float last = cums_g[crow + QP - 1];
  for (int i = tid; i < QP; i += THREADS) {
    const float cv = cums_g[crow + i];
    cums[i] = cv;
    dts[i] = i < len ? dtb[(size_t)i * H] : 0.f;
    wts[i] = expf(last - cv);
  }
  const int jl = j0 + r0 + gq, jh = jl + 8;  // this thread's rows (chunk-relative)
  const int nsteps = (len - j0 + H2 - 1) / H2;   // half tiles i0 = j0 + 32 s
  const int nsw = max((P + PPASS - 1) / PPASS, (N + NW - 1) / NW);
  const int PK = round_up(P, 8), NK = round_up(N, 8);
  float colp[2] = {0.f, 0.f}, vp[2] = {0.f, 0.f}, xdp[2] = {0.f, 0.f};

  for (int sw = 0; sw < nsw; ++sw) {
    const int ps0 = sw * PPASS, ns0 = sw * NW;
    const bool do_x = ps0 < P, do_b = ns0 < N;
    float dX[8][4], dB[NB][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) f32::zero(dX[nb]);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) f32::zero(dB[nb]);
    __syncthreads();                         // the region's last readers are done
    if (ds_terms) {
      float* Bj = reg;                       // [64][ldb]
      float* Ds = reg + T * ldb;             // [NR][ldx]
      f32::load_tile(Bj, ldb, bb + (long long)j0 * b_ss, b_ss, T, L.NR, len - j0, N, vec,
                     tid, THREADS);
      f32::load_tile(Ds, ldx, dso, P, L.NR, L.PW, N, P, vdy, tid, THREADS);
      sm90::cp_async_commit();
      sm90::cp_async_wait<0>();
      __syncthreads();                       // x_J, B_J, dS_out, cums for every thread
      const float dl = dts[jl], dh = dts[jh], wl = wts[jl], wh = wts[jh];
      if (do_b) {
        // u = xbar_J dS_out^T on this sweep's columns; v_j += B_j . u_j; dB = w u
        for (int kp = 0; kp < PK; kp += 8) {
          const auto af = f32::frag_a(xs, ldx, r0, kp, lane, dl, dh);
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
            mma3(dB[nb], af, f32::frag_b_t(Ds, ldx, ns0 + 8 * nb, kp, lane));
        }
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          const float* bl = Bj + (r0 + gq) * ldb + ns0 + 8 * nb + t2;
          vp[0] += bl[0] * dB[nb][0] + bl[1] * dB[nb][1];
          vp[1] += bl[8 * ldb] * dB[nb][2] + bl[8 * ldb + 1] * dB[nb][3];
          dB[nb][0] *= wl;
          dB[nb][1] *= wl;
          dB[nb][2] *= wh;
          dB[nb][3] *= wh;
        }
      }
      if (do_x) {
        // dxbar_J = w (B_J dS_out) on this sweep's columns of P
        for (int kn = 0; kn < NK; kn += 8) {
          const auto af = f32::frag_a(Bj, ldb, r0, kn, lane);
#pragma unroll
          for (int nb = 0; nb < 8; ++nb)
            mma3(dX[nb], af, f32::frag_b(Ds, ldx, kn, ps0 + 8 * nb, lane));
        }
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          dX[nb][0] *= wl;
          dX[nb][1] *= wl;
          dX[nb][2] *= wh;
          dX[nb][3] *= wh;
        }
      }
      __syncthreads();                       // B_J and dS_out are consumed
    }

    auto load = [&](int s) {                 // one commit group a step, empty past the end
      if (s < nsteps) {
        float* st = reg + (s % NST) * L.stage;
        const int i0 = j0 + s * H2;
        f32::load_tile(st, ldx, dyb + (long long)i0 * dy_ss, dy_ss, H2, L.PW, len - i0,
                       P, vdy, tid, THREADS);
        f32::load_tile(st + H2 * ldx, LDN, cmb + (long long)i0 * c_ss + ns0, c_ss, H2,
                       NW, len - i0, N - ns0, vec, tid, THREADS);
        f32::load_tile(st + H2 * (ldx + LDN), LDQ, cbb + (size_t)i0 * QP, QP, H2, T, H2,
                       T, true, tid, THREADS);
      }
      sm90::cp_async_commit();
    };
#pragma unroll
    for (int s = 0; s < NST - 1; ++s) load(s);
    const float dl = dts[jl], dh = dts[jh];
    const float cjl = cums[jl], cjh = cums[jh];
    for (int s = 0; s < nsteps; ++s) {
      sm90::cp_async_wait<NST - 2>();
      __syncthreads();                       // step s for every thread; s - 1 consumed
      load(s + NST - 1);
      const float* dys = reg + (s % NST) * L.stage;
      const float* Cs = dys + H2 * ldx;
      const float* Qs = Cs + H2 * LDN;
      const int i0 = j0 + s * H2;
      // on the diagonal tile, this warp's rows j see the rows i >= j0 + r0
      const int ii_lo = max(0, (j0 + r0 - i0) / 8);
      if (ii_lo < 4) {
        float gt[4][4];                      // G^T [16 j][32 i]
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) f32::zero(gt[ii]);
        for (int kp = 0; kp < PK; kp += 8) {
          const auto af = f32::frag_a(xs, ldx, r0, kp, lane, dl, dh);
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
            if (ii >= ii_lo) mma3(gt[ii], af, f32::frag_b_t(dys, ldx, 8 * ii, kp, lane));
        }
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          if (ii < ii_lo) continue;
          const int ia = i0 + 8 * ii + t2, ib = ia + 1;
          // (C B^T)_ij at (jl, ia), (jl, ib), (jh, ia), (jh, ib)
          const float* q = Qs + (8 * ii + t2) * LDQ + r0 + gq;
          const float cw[4] = {q[0], q[LDQ], q[8], q[LDQ + 8]};
          const float ca = cums[ia], cbv = cums[ib];
          // mask before exp: only j <= i < len is exponentiated
          const float e[4] = {jl <= ia && ia < len ? expf(ca - cjl) : 0.f,
                              jl <= ib && ib < len ? expf(cbv - cjl) : 0.f,
                              jh <= ia && ia < len ? expf(ca - cjh) : 0.f,
                              jh <= ib && ib < len ? expf(cbv - cjh) : 0.f};
          float wv[4], zv[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            wv[k] = cw[k] * e[k];
            zv[k] = gt[ii][k] * e[k];
          }
          if (sw == 0) {
            colp[0] += wv[0] * gt[ii][0] + wv[1] * gt[ii][1];
            colp[1] += wv[2] * gt[ii][2] + wv[3] * gt[ii][3];
          }
          if (do_x) {
            const auto aw = acc_as_a(wv);
#pragma unroll
            for (int nb = 0; nb < 8; ++nb)
              mma3(dX[nb], aw, f32::frag_b_perm(dys, ldx, 8 * ii, ps0 + 8 * nb, lane));
          }
          if (do_b) {
            const auto az = acc_as_a(zv);
#pragma unroll
            for (int nb = 0; nb < NB; ++nb)
              mma3(dB[nb], az, f32::frag_b_perm(Cs, LDN, 8 * ii, 8 * nb, lane));
          }
        }
      }
    }

    // this sweep's outputs: dx = dt dxbar, x . dxbar, dB per head
    const size_t rl = ((size_t)b * S + c0 + jl) * H + h, rh = rl + 8 * (size_t)H;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int j = hf ? jh : jl;
      if (j >= len) continue;
      const size_t row = hf ? rh : rl;
      const float d = hf ? dh : dl;
      if (do_x) {
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          const int p = ps0 + 8 * nb + t2;
          const float* xr = xs + (r0 + gq + 8 * hf) * ldx + p;
          if (p < P) {
            dx[row * P + p] = d * dX[nb][2 * hf];
            xdp[hf] += xr[0] * dX[nb][2 * hf];
          }
          if (p + 1 < P) {
            dx[row * P + p + 1] = d * dX[nb][2 * hf + 1];
            xdp[hf] += xr[1] * dX[nb][2 * hf + 1];
          }
        }
      }
      if (do_b) {
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          const int n = ns0 + 8 * nb + t2;
          if (n < N) dbh[row * N + n] = dB[nb][2 * hf];
          if (n + 1 < N) dbh[row * N + n + 1] = dB[nb][2 * hf + 1];
        }
      }
    }
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const float cs = quad_sum(colp[hf]), vs = quad_sum(vp[hf]), xd = quad_sum(xdp[hf]);
    const int j = hf ? jh : jl;
    if ((lane & 3) == 0 && j < len) {
      const float v = vs * wts[j];
      xdx[crow + j] = xd;
      vout[crow + j] = v;
      colpart[crow + j] = cs + v;
    }
  }
}

// ---------------------------------------------------------------------------
// 5. The row pass, grid (B * H, nc, QP / 64): tile I = QP / 64 - 1 -
// blockIdx.z (the most pairs first).  Warp w owns the rows i0 + 16 w .. + 15
// of I; its accumulator: dC [16][NW].
// ---------------------------------------------------------------------------
template <int NB>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_row_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ bm, const float* __restrict__ cm,
                   const float* __restrict__ dy, const float* __restrict__ cums_g,
                   const float* __restrict__ cb, const float* __restrict__ s_in,
                   float* __restrict__ dch, float* __restrict__ rowpart, int S, int H,
                   int G, int N, int P, int Q, int QP, int nc, int has_state,
                   long long x_sb, long long x_ss, long long b_sb, long long b_ss,
                   long long c_sb, long long c_ss, int vec) {
  constexpr int NW = 8 * NB, LDN = ld4(NW), LDQ = ld8(H2);
  const RowPlan L(P, NW, QP);
  const int ldp = L.ldp, PK = L.PK;
  extern __shared__ __align__(16) float smem[];
  float* dys = smem;                         // dy_I [64][ldp]
  float* reg = dys + T * ldp;                // S_in and C_I, then the stages
  float* cums = reg + L.region;              // [QP]
  float* dts = cums + QP;                    // [QP]
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5, r0 = 16 * w;
  const int gq = lane >> 2, t2 = 2 * (lane & 3);
  const int bh = blockIdx.x, c = blockIdx.y, it = gridDim.z - 1 - blockIdx.z;
  const int b = bh / H, h = bh % H, g = h / (H / G);
  const int c0 = c * Q, len = min(Q, S - c0), i0 = it * T;
  if (i0 >= len) return;                     // past the ragged edge
  const long long dy_ss = (long long)H * P;
  const float* xb = x + b * x_sb + (long long)c0 * x_ss + (long long)h * P;
  const float* bb = bm + b * b_sb + (long long)c0 * b_ss + (long long)g * N;
  const float* cmb = cm + b * c_sb + (long long)c0 * c_ss + (long long)g * N;
  const float* dyb = dy + ((size_t)b * S + c0) * H * P + (size_t)h * P;
  const float* dtb = dt + ((size_t)b * S + c0) * H + h;
  const float* cbb = cb + ((size_t)(b * G + g) * nc + c) * QP * QP + (size_t)i0 * QP;
  const float* sin_c = s_in + ((size_t)bh * nc + c) * N * P;
  const bool vdy = (P & 3) == 0;
  const bool inter = has_state || c > 0;     // S_in is 0 otherwise
  const size_t crow = ((size_t)bh * nc + c) * QP;

  f32::load_tile(dys, ldp, dyb + (long long)i0 * dy_ss, dy_ss, T, PK, len - i0, P, vdy,
                 tid, THREADS);
  sm90::cp_async_commit();
  for (int i = tid; i < QP; i += THREADS) {
    cums[i] = cums_g[crow + i];
    dts[i] = i < len ? dtb[(size_t)i * H] : 0.f;
  }
  const int il = i0 + r0 + gq, ih = il + 8;  // this thread's rows (chunk-relative)
  const int nsteps = min(2 * it + 2, (len + H2 - 1) / H2);   // half tiles j0 = 32 s
  const int nsw = (N + NW - 1) / NW;
  float rowp[2] = {0.f, 0.f}, tp[2] = {0.f, 0.f};

  for (int sw = 0; sw < nsw; ++sw) {
    const int ns0 = sw * NW;
    float dC[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) f32::zero(dC[nb]);
    __syncthreads();                         // the region's last readers are done
    if (inter) {
      // dC_I = e^cums (dy_I S_in^T) on this sweep's columns; t_i += C_i . (S_in dy_i)
      float* Ss = reg;                       // S_in rows ns0.. [NW][ldp]
      float* Ci = reg + NW * ldp;            // C_I columns ns0.. [64][LDN]
      f32::load_tile(Ss, ldp, sin_c + (size_t)ns0 * P, P, NW, PK, N - ns0, P, vdy, tid,
                     THREADS);
      f32::load_tile(Ci, LDN, cmb + (long long)i0 * c_ss + ns0, c_ss, T, NW, len - i0,
                     N - ns0, vec, tid, THREADS);
      sm90::cp_async_commit();
      sm90::cp_async_wait<0>();
      __syncthreads();
      for (int kp = 0; kp < PK; kp += 8) {
        const auto af = f32::frag_a(dys, ldp, r0, kp, lane);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          mma3(dC[nb], af, f32::frag_b_t(Ss, ldp, 8 * nb, kp, lane));
      }
      const float el = expf(cums[il]), eh = expf(cums[ih]);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const float* cl = Ci + (r0 + gq) * LDN + 8 * nb + t2;
        tp[0] += cl[0] * dC[nb][0] + cl[1] * dC[nb][1];
        tp[1] += cl[8 * LDN] * dC[nb][2] + cl[8 * LDN + 1] * dC[nb][3];
        dC[nb][0] *= el;
        dC[nb][1] *= el;
        dC[nb][2] *= eh;
        dC[nb][3] *= eh;
      }
      __syncthreads();                       // S_in and C_I are consumed
    }

    auto load = [&](int s) {                 // one commit group a step, empty past the end
      if (s < nsteps) {
        float* st = reg + (s % NST) * L.stage;
        const int j0 = s * H2;
        f32::load_tile(st, ldp, xb + (long long)j0 * x_ss, x_ss, H2, PK, len - j0, P, vec,
                       tid, THREADS);
        f32::load_tile(st + H2 * ldp, LDN, bb + (long long)j0 * b_ss + ns0, b_ss, H2, NW,
                       len - j0, N - ns0, vec, tid, THREADS);
        f32::load_tile(st + H2 * (ldp + LDN), LDQ, cbb + j0, QP, T, H2, T, H2, true, tid,
                       THREADS);
      }
      sm90::cp_async_commit();
    };
#pragma unroll
    for (int s = 0; s < NST - 1; ++s) load(s);
    for (int s = 0; s < nsteps; ++s) {
      sm90::cp_async_wait<NST - 2>();
      __syncthreads();                       // step s (and dy_I, cums) for every thread
      load(s + NST - 1);
      const float* xsh = reg + (s % NST) * L.stage;
      const float* Bs = xsh + H2 * ldp;
      const float* Qs = Bs + H2 * LDN;
      const int j0 = s * H2;
      // the 8-column blocks this warp's rows see: j0 + 8 jj <= i0 + r0 + 15
      const int d = i0 + r0 + 15 - j0;
      const int jj_end = d < 0 ? 0 : min(4, d / 8 + 1);
      if (jj_end > 0) {
        float gm[4][4];                      // G [16 i][32 j]
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) f32::zero(gm[jj]);
        for (int kp = 0; kp < PK; kp += 8) {
          const auto af = f32::frag_a(dys, ldp, r0, kp, lane);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            if (jj < jj_end)
              mma3(gm[jj], af, f32::frag_b_t(xsh, ldp, 8 * jj, kp, lane, dts[j0 + 8 * jj + gq]));
        }
        const float cil = cums[il], cih = cums[ih];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          if (jj >= jj_end) continue;
          const int ja = j0 + 8 * jj + t2, jb = ja + 1;
          const float2 ql = *reinterpret_cast<const float2*>(Qs + (r0 + gq) * LDQ + 8 * jj + t2);
          const float2 qh = *reinterpret_cast<const float2*>(Qs + (r0 + gq + 8) * LDQ + 8 * jj + t2);
          const float ca = cums[ja], cbv = cums[jb];
          // mask before exp: only j <= i < len is exponentiated
          const float e[4] = {ja <= il && il < len ? expf(cil - ca) : 0.f,
                              jb <= il && il < len ? expf(cil - cbv) : 0.f,
                              ja <= ih && ih < len ? expf(cih - ca) : 0.f,
                              jb <= ih && ih < len ? expf(cih - cbv) : 0.f};
          const float zv[4] = {gm[jj][0] * e[0], gm[jj][1] * e[1], gm[jj][2] * e[2],
                               gm[jj][3] * e[3]};
          if (sw == 0) {
            rowp[0] += ql.x * e[0] * gm[jj][0] + ql.y * e[1] * gm[jj][1];
            rowp[1] += qh.x * e[2] * gm[jj][2] + qh.y * e[3] * gm[jj][3];
          }
          const auto az = acc_as_a(zv);
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
            mma3(dC[nb], az, f32::frag_b_perm(Bs, LDN, 8 * jj, 8 * nb, lane));
        }
      }
    }

#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = hf ? ih : il;
      if (i >= len) continue;
      float* row = dch + (((size_t)b * S + c0 + i) * H + h) * N;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int n = ns0 + 8 * nb + t2;
        if (n < N) row[n] = dC[nb][2 * hf];
        if (n + 1 < N) row[n + 1] = dC[nb][2 * hf + 1];
      }
    }
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const float rs = quad_sum(rowp[hf]), ts = quad_sum(tp[hf]);
    const int i = hf ? ih : il;
    if ((lane & 3) == 0 && i < len) rowpart[crow + i] = rs + ts * expf(cums[i]);
  }
}

// ---------------------------------------------------------------------------
// 6. grid (nc, B * H): dcums_i = rowpart_i - colpart_i, the last row's
// sum_j v_j + e^last <S_in, dS_out> added to every position, d(dtA) its
// reverse cumsum (warp 0: runs of QP / 32 a lane, then a suffix scan across
// lanes), ddt = A d(dtA) + x . dxbar, and the chunk's part of dA.
// ---------------------------------------------------------------------------
constexpr int FIN_THREADS = 256;

__global__ void __launch_bounds__(FIN_THREADS)
ssd_bwd_finish_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                      const float* __restrict__ cums, const float* __restrict__ s_in,
                      const float* __restrict__ ds_out,
                      const float* __restrict__ rowpart,
                      const float* __restrict__ colpart,
                      const float* __restrict__ vin, const float* __restrict__ xdx,
                      float* __restrict__ ddt, float* __restrict__ dapart, int S,
                      int H, int N, int P, int Q, int QP, int nc) {
  const int c = blockIdx.x, bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int c0 = c * Q, len = min(Q, S - c0);
  extern __shared__ float fsm[];
  float* dc = fsm;                           // [QP]
  float* red = dc + QP;                      // [FIN_THREADS]
  const int tid = threadIdx.x;
  const size_t base = ((size_t)bh * nc + c) * QP;
  const size_t sbase = ((size_t)bh * nc + c) * N * P;

  float dot = 0.f, vs = 0.f;
  for (int e = tid; e < N * P; e += FIN_THREADS) dot = fmaf(s_in[sbase + e], ds_out[sbase + e], dot);
  for (int i = tid; i < len; i += FIN_THREADS) vs += vin[base + i];
  for (int i = tid; i < QP; i += FIN_THREADS)
    dc[i] = i < len ? rowpart[base + i] - colpart[base + i] : 0.f;
  red[tid] = dot;
  __syncthreads();
  for (int off = FIN_THREADS / 2; off > 0; off >>= 1) {
    if (tid < off) red[tid] += red[tid + off];
    __syncthreads();
  }
  dot = red[0];
  __syncthreads();
  red[tid] = vs;
  __syncthreads();
  for (int off = FIN_THREADS / 2; off > 0; off >>= 1) {
    if (tid < off) red[tid] += red[tid + off];
    __syncthreads();
  }
  const float lastterm = red[0] + expf(cums[base + QP - 1]) * dot;

  if (tid < 32) {
    const int per = (QP + 31) / 32, s0 = tid * per, s1 = min(QP, s0 + per);
    float run = 0.f;
    for (int i = s0; i < s1; ++i) run += dc[i];
    // the sum of the runs of the lanes above this one
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_down_sync(0xffffffffu, incl, off);
      if (tid + off < 32) incl += o;
    }
    float above = __shfl_down_sync(0xffffffffu, incl, 1);
    if (tid == 31) above = 0.f;
    float r = lastterm + above, da = 0.f;
    const float a = A[h];
    for (int i = s1 - 1; i >= s0; --i) {
      r += dc[i];
      if (i < len) {
        const size_t row = (size_t)b * S + c0 + i;
        const float dtv = dt[row * H + h];
        ddt[row * H + h] = fmaf(a, r, xdx[base + i]);
        da = fmaf(dtv, r, da);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) da += __shfl_xor_sync(0xffffffffu, da, off);
    if (tid == 0) dapart[(size_t)bh * nc + c] = da;
  }
}

// ---------------------------------------------------------------------------
// 7. dB, dC [B, S, G, N] = the sums of dbh, dch over each group's heads in
// order; dA[h] = the sum of dapart over (batch, chunk) in order.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(FIN_THREADS)
ssd_bwd_sum_kernel(const float* __restrict__ dbh, const float* __restrict__ dch,
                   const float* __restrict__ dapart, float* __restrict__ db,
                   float* __restrict__ dcg, float* __restrict__ da, int B, int S,
                   int H, int G, int N, int nc) {
  const size_t idx = (size_t)blockIdx.x * FIN_THREADS + threadIdx.x;
  const size_t total = (size_t)B * S * G * N;
  if (idx < (size_t)H) {
    float s = 0.f;
    for (int b = 0; b < B; ++b)
      for (int c = 0; c < nc; ++c) s += dapart[((size_t)b * H + idx) * nc + c];
    da[idx] = s;
  }
  if (idx >= total) return;
  const int rep = H / G;
  const int n = idx % N;
  const size_t bsg = idx / N;
  const int g = bsg % G;
  const size_t bs = bsg / G;
  const size_t src = (bs * H + (size_t)g * rep) * N + n;
  float sb = 0.f, sc = 0.f;
  for (int r = 0; r < rep; ++r) {
    sb += dbh[src + (size_t)r * N];
    sc += dch[src + (size_t)r * N];
  }
  db[idx] = sb;
  dcg[idx] = sc;
}

template <typename K>
cudaError_t set_smem(K* kernel, int bytes) {
  if (bytes > 232448) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess || bytes <= 48 * 1024) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// the column and row passes at NB = 8-column blocks of N a sweep
template <int NB>
cudaError_t launch_pairs(const float* x, const float* dt, const float* bm,
                         const float* cm, const float* dy, const float* cums,
                         const float* cb, const float* s_in, const float* ds_out,
                         float* dx, float* dbh, float* dch, float* rowpart,
                         float* colpart, float* vv, float* xdx, int B, int S, int H,
                         int G, int N, int P, int Q, int QP, int nc, int has_state,
                         int has_ds, long long x_sb, long long x_ss, long long b_sb,
                         long long b_ss, long long c_sb, long long c_ss, int vec,
                         cudaStream_t st) {
  const dim3 grid(B * H, nc, QP / T);
  const int s_col = 4 * ColPlan(N, P, 8 * NB, QP).total;
  cudaError_t err = set_smem(ssd_bwd_col_kernel<NB>, s_col);
  if (err != cudaSuccess) return err;
  ssd_bwd_col_kernel<NB><<<grid, THREADS, s_col, st>>>(
      x, dt, bm, cm, dy, cums, cb, ds_out, dx, dbh, colpart, vv, xdx, S, H, G, N, P, Q,
      QP, nc, has_ds, x_sb, x_ss, b_sb, b_ss, c_sb, c_ss, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int s_row = 4 * RowPlan(P, 8 * NB, QP).total;
  if ((err = set_smem(ssd_bwd_row_kernel<NB>, s_row)) != cudaSuccess) return err;
  ssd_bwd_row_kernel<NB><<<grid, THREADS, s_row, st>>>(
      x, dt, bm, cm, dy, cums, cb, s_in, dch, rowpart, S, H, G, N, P, Q, QP, nc,
      has_state, x_sb, x_ss, b_sb, b_ss, c_sb, c_ss, vec);
  return cudaGetLastError();
}

}  // namespace

// The SSD's VJP.  Inputs as ssd_chunk_fwd's float32 instance (x, B, C with
// strides in elements; dt, A, state_in contiguous; state_in may be null),
// dy [B, S, H, P] and dstate [B, H, N, P] (or null: no cotangent of the
// final state) contiguous; outputs dx [B, S, H, P], ddt [B, S, H], dA [H],
// dB and dC [B, S, G, N], dstate_in [B, H, N, P] (null when state_in is);
// ws0..ws11 the scratch of kernels/ssd_chunk.py::_bwd_workspace; counters:
// B*H*ceil(P / 64) zeroed ticket counters (the forward's), left at zero.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int ssd_chunk_bwd(const void* x, const void* dt, const void* A,
                             const void* bm, const void* cm, const void* state_in,
                             const void* dy, const void* dstate, void* dx,
                             void* ddt, void* dA, void* dB, void* dC,
                             void* dstate_in, void* ws0, void* ws1, void* ws2,
                             void* ws3, void* ws4, void* ws5, void* ws6,
                             void* ws7, void* ws8, void* ws9, void* ws10,
                             void* ws11, void* counters, int B, int S, int H,
                             int G, int N, int P, int Q, int nc, long long x_sb,
                             long long x_ss, long long b_sb, long long b_ss,
                             long long c_sb, long long c_ss, void* stream) {
  if (B <= 0 || S <= 0 || G <= 0 || H % G != 0 || N <= 0 || N > 256 || P <= 0 ||
      Q <= 0 || Q > S || Q > 1024 || nc != (S + Q - 1) / Q || counters == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A);
  const float* bf = static_cast<const float*>(bm);
  const float* cf = static_cast<const float*>(cm);
  const float* dyf = static_cast<const float*>(dy);
  float* cums = static_cast<float*>(ws0);
  float* last = static_cast<float*>(ws1);
  float* s_in = static_cast<float*>(ws2);
  float* dso = static_cast<float*>(ws3);
  float* cb = static_cast<float*>(ws4);
  float* dbh = static_cast<float*>(ws5);
  float* dch = static_cast<float*>(ws6);
  float* rowpart = static_cast<float*>(ws7);
  float* colpart = static_cast<float*>(ws8);
  float* vv = static_cast<float*>(ws9);
  float* xdx = static_cast<float*>(ws10);
  float* dapart = static_cast<float*>(ws11);
  unsigned* tickets = static_cast<unsigned*>(counters);
  const int QP = round_up(Q, T);
  const int vec = aligned16(x) && aligned16(bm) && aligned16(cm) && aligned16(dy) &&
                  N % 4 == 0 && P % 4 == 0 && x_sb % 4 == 0 && x_ss % 4 == 0 &&
                  b_sb % 4 == 0 && b_ss % 4 == 0 && c_sb % 4 == 0 && c_ss % 4 == 0;
  const long long dy_sb = (long long)S * H * P, dy_ss = (long long)H * P;
  cudaError_t err;

  if ((err = f32::launch_cb(1, bf, cf, cb, B, S, G, N, Q, QP, nc, b_sb, b_ss, c_sb, c_ss,
                            vec, st)) != cudaSuccess)
    return err;
  if ((err = f32::launch_state(1, 0, bf, xf, dtf, af, static_cast<const float*>(state_in),
                               s_in, s_in, nullptr, cums, last, tickets, B, S, H, G, N,
                               P, Q, QP, nc, b_sb, b_ss, x_sb, x_ss, vec, st)) != cudaSuccess)
    return err;
  if ((err = f32::launch_state(1, 1, cf, dyf, dtf, af, static_cast<const float*>(dstate),
                               dso, dso, static_cast<float*>(dstate_in), nullptr, last,
                               tickets, B, S, H, G, N, P, Q, QP, nc, c_sb, c_ss, dy_sb,
                               dy_ss, vec, st)) != cudaSuccess)
    return err;

  const int has_state = state_in != nullptr, has_ds = dstate != nullptr;
  const int nw = N >= 128 ? 128 : round_up(N, 32);
#define REPRO_SSD_PAIRS(nb)                                                     \
  case nb:                                                                      \
    err = launch_pairs<nb>(xf, dtf, bf, cf, dyf, cums, cb, s_in, dso,           \
                           static_cast<float*>(dx), dbh, dch, rowpart, colpart, \
                           vv, xdx, B, S, H, G, N, P, Q, QP, nc, has_state,     \
                           has_ds, x_sb, x_ss, b_sb, b_ss, c_sb, c_ss, vec, st); \
    break;
  switch (nw / 8) {
    REPRO_SSD_PAIRS(4)
    REPRO_SSD_PAIRS(8)
    REPRO_SSD_PAIRS(12)
    REPRO_SSD_PAIRS(16)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_SSD_PAIRS
  if (err != cudaSuccess) return err;

  ssd_bwd_finish_kernel<<<dim3(nc, B * H), FIN_THREADS,
                          sizeof(float) * (QP + FIN_THREADS), st>>>(
      dtf, af, cums, s_in, dso, rowpart, colpart, vv, xdx, static_cast<float*>(ddt),
      dapart, S, H, N, P, Q, QP, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t total = (size_t)B * S * G * N;
  const size_t work = total > (size_t)H ? total : (size_t)H;
  ssd_bwd_sum_kernel<<<(unsigned)((work + FIN_THREADS - 1) / FIN_THREADS), FIN_THREADS, 0,
                       st>>>(dbh, dch, dapart, static_cast<float*>(dB),
                             static_cast<float*>(dC), static_cast<float*>(dA), B, S, H, G,
                             N, nc);
  return cudaGetLastError();
}
