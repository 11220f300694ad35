// The backward of the Mamba-2 SSD chunk scan for Hopper (sm_90a), float32.
//
// Replaces no TPU kernel: the reference differentiates its XLA path,
// src/repro/models/mamba2.py::ssd_chunked, and the Pallas kernel
// src/repro/kernels/ssd_chunk.py has no backward.  It computes the VJP of
// the chunked SSD that csrc/ssd_chunk.cu computes forward (the formulas are
// written out in kernels/ssd_chunk.py::ssd_bwd_plain).  Per chunk of Q
// steps of one (batch, head), with cums_i = sum_{k<=i} dt_k A,
// xbar_j = dt_j x_j, E_ij = e^(cums_i - cums_j) for j <= i (else 0),
// W = (C B^T) o E, Z = (dy xbar^T) o E, R = W o (dy xbar^T), S_in the state
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
// (B=2, S=512, H=64, P=64, G=1, N=128, Q=256) the function needs 11.9 GFLOP
// of float32 products (0.18 ms at 67 TFLOP/s on the CUDA cores) against
// 53 MB that must move (16 us); the passes below recompute the tiles of
// C B^T and dy xbar^T twice and run whole 64 x 64 tiles on the diagonal,
// ~20 GFLOP in all.  This first design is simple and right: float32 FMAs
// from shared memory, as K4's float32 forward instance, with no atomics
// (every sum is taken in a fixed order, so two calls give the same bits).
// Seven launches:
//  1. ssd_bwd_cums_kernel: cums per (batch * head, chunk), the forward's
//     warp scan;
//  2. ssd_bwd_state_kernel<false>: S_in of every chunk, one block per
//     (batch * head, 16 state columns) walking the chunks in order (the
//     forward's state recurrence);
//  3. ssd_bwd_state_kernel<true>: dS_out of every chunk, the same walk
//     backwards from dS_final (or 0) with C e^cums and dy; it ends at
//     d state_in;
//  4. ssd_bwd_col_kernel, one block per (batch * head, chunk, 64-row tile
//     J): for every tile I >= J the 64 x 64 tiles of C B^T and dy xbar^T,
//     then dxbar_J, dB_J (per head) and the column sums of R; the dS_out
//     terms; dx, v and x . dxbar;
//  5. ssd_bwd_row_kernel, one block per (batch * head, chunk, tile I): for
//     every tile J <= I the same two tiles, then dC_I (per head) and the
//     row sums of R; the S_in terms;
//  6. ssd_bwd_finish_kernel, one block per (batch * head, chunk): dcums,
//     its reverse cumsum (a warp scan), ddt and the chunk's part of dA;
//  7. ssd_bwd_sum_kernel: dB and dC over each group's heads in the order
//     h = g rep .. g rep + rep - 1, and dA over (batch, chunk) in order.
// The row and column passes each recompute the tiles of C B^T and dy xbar^T
// they need (the pairs below the diagonal twice in all): the price of
// keeping every sum in one block.
//
// Layout: as the forward.  x [B, S, H, P] and B/C [B, S, G, N] with their
// last two dims contiguous and any stride between batch rows and positions;
// dt, dy, the states and every output contiguous float32.  The ragged S
// edge is masked: positions past S have dt = 0 in the forward's padding, so
// the padded rows add nothing but the last row's carry terms, which are
// added to every position of the chunk.

#include <stdint.h>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int T = 64;        // rows of a tile, and the width of a slab
constexpr int TS = T + 1;    // row stride of a 64 x 64 tile in shared memory
constexpr int PT = 16;       // state columns (of P) per state-walk block
constexpr int MAXK = 16;     // state rows per thread: N <= 16 * MAXK = 256

// ---------------------------------------------------------------------------
// 1. cums[bh][c][i] = sum_{k<=i} dt A within chunk c (steps past S: dt = 0);
// grid (nc, B * H), 32 threads: lane l scans a contiguous run of Q / 32,
// then the runs' totals are scanned across the warp (the forward's scan).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(32)
ssd_bwd_cums_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                    float* __restrict__ cums, int S, int H, int Q, int nc) {
  const int c = blockIdx.x, bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int c0 = c * Q, len = min(Q, S - c0);
  const float a = A[h];
  const float* dtb = dt + (size_t)b * S * H + h;
  float* out = cums + ((size_t)bh * nc + c) * Q;
  const int lane = threadIdx.x;
  const int per = (Q + 31) / 32, s0 = lane * per;
  float run = 0.f;
  for (int k = 0; k < per; ++k) {
    const int i = s0 + k;
    if (i < Q) {
      run += i < len ? dtb[(size_t)(c0 + i) * H] * a : 0.f;
      out[i] = run;
    }
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  for (int k = 0; k < per; ++k) {
    const int i = s0 + k;
    if (i < Q) out[i] += excl;
  }
}

// ---------------------------------------------------------------------------
// 2./3. The state walks; grid (ceil(P / PT), B * H).  Thread (rr, pp) =
// (tid / 16, tid % 16) owns state column p0 + pp, rows n = rr + 16 k.
// Forward (REV false): S_in(0) = state_in or 0, S_in(c + 1) = S_in(c)
//   e^last_c + sum_j e^(last_c - cums_j) B_j (dt_j x_j)^T; writes S_in(c).
// Reverse (REV true): dS_out(nc - 1) = dS_final or 0, dS_out(c - 1) =
//   dS_out(c) e^last_c + sum_i e^cums_i C_i dy_i^T; writes dS_out(c), and
//   the carry past chunk 0 to d state_in.
// ---------------------------------------------------------------------------
template <bool REV>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_state_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ u, const float* __restrict__ dy,
                     const float* __restrict__ cums, const float* __restrict__ init,
                     float* __restrict__ states, float* __restrict__ final_out,
                     int S, int H, int G, int N, int P, int Q, int nc,
                     long long x_sb, long long x_ss, long long u_sb,
                     long long u_ss) {
  const int NS = N + 1;
  extern __shared__ float smem[];
  float* tile = smem;               // [T][NS] rows of B (or C), weighted
  float* vt = tile + T * NS;        // [T][PT] dt x (or dy)
  float* wt = vt + T * PT;          // [T] the rows' weights

  const int tid = threadIdx.x;
  const int rr = tid / PT, pp = tid % PT;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int g = h / (H / G);
  const int p0 = blockIdx.x * PT;
  const bool pcol = p0 + pp < P;
  const float* ub = u + b * u_sb + (long long)g * N;

  float sacc[MAXK];
#pragma unroll
  for (int k = 0; k < MAXK; ++k) {
    const int n = rr + 16 * k;
    sacc[k] = (init != nullptr && n < N && pcol)
                  ? init[((size_t)bh * N + n) * P + p0 + pp] : 0.f;
  }
  for (int step = 0; step < nc; ++step) {
    const int c = REV ? nc - 1 - step : step;
    const int c0 = c * Q, len = min(Q, S - c0);
    const float* cc = cums + ((size_t)bh * nc + c) * Q;
    const float last = cc[Q - 1];
#pragma unroll
    for (int k = 0; k < MAXK; ++k) {
      const int n = rr + 16 * k;
      if (n < N && pcol) states[(((size_t)bh * nc + c) * N + n) * P + p0 + pp] = sacc[k];
    }
    if (!REV && step == nc - 1) break;    // the final state is not needed
    const float dl = expf(last);
#pragma unroll
    for (int k = 0; k < MAXK; ++k) sacc[k] *= dl;
    for (int j0 = 0; j0 < len; j0 += T) {
      __syncthreads();                    // the previous tile is consumed
      if (tid < T) {
        const int j = j0 + tid;
        wt[tid] = j < len ? (REV ? expf(cc[j]) : expf(last - cc[j])) : 0.f;
      }
      __syncthreads();
      for (int e = tid; e < T * N; e += THREADS) {
        const int r = e / N, n = e % N, j = j0 + r;
        tile[r * NS + n] = j < len ? ub[(c0 + j) * u_ss + n] * wt[r] : 0.f;
      }
      for (int e = tid; e < T * PT; e += THREADS) {
        const int r = e / PT, q = e % PT, j = j0 + r;
        float v = 0.f;
        if (j < len && p0 + q < P) {
          const size_t row = (size_t)b * S + c0 + j;
          v = REV ? dy[(row * H + h) * P + p0 + q]
                  : x[b * x_sb + (c0 + j) * x_ss + (long long)h * P + p0 + q] *
                        dt[row * H + h];
        }
        vt[e] = v;
      }
      __syncthreads();
      const int jn = min(T, len - j0);
      for (int jj = 0; jj < jn; ++jj) {
        const float xv = vt[jj * PT + pp];
#pragma unroll
        for (int k = 0; k < MAXK; ++k) {
          const int n = rr + 16 * k;
          if (n < N) sacc[k] = fmaf(tile[jj * NS + n], xv, sacc[k]);
        }
      }
    }
  }
  if (REV && final_out != nullptr) {
#pragma unroll
    for (int k = 0; k < MAXK; ++k) {
      const int n = rr + 16 * k;
      if (n < N && pcol) final_out[((size_t)bh * N + n) * P + p0 + pp] = sacc[k];
    }
  }
}

// ---------------------------------------------------------------------------
// The chunk passes.  Thread (ty, tx) = (tid / 16, tid % 16) owns rows
// ty + 16 r and columns tx + 16 q (r, q < 4) of every 64 x 64 product.
// ---------------------------------------------------------------------------

// D[r][k] = src[r * rstride + k0 + k] (times rscale[r * sstride]) for r <
// rows and k0 + k < cols, else 0: a 64 x 64 slab of a row-major matrix
__device__ __forceinline__ void load_slab(float* D, const float* src,
                                          long long rstride, int rows, int cols,
                                          int k0, const float* rscale,
                                          long long sstride, int tid) {
  for (int e = tid; e < T * T; e += THREADS) {
    const int r = e / T, k = e % T, col = k0 + k;
    float v = 0.f;
    if (r < rows && col < cols) {
      v = src[r * rstride + col];
      if (rscale != nullptr) v *= rscale[r * sstride];
    }
    D[r * TS + k] = v;
  }
}

// acc[r][q] += sum_k A[row r][k] * B[row q][k]   (A B^T)
__device__ __forceinline__ void prod_nt(float acc[4][4], const float* A,
                                        const float* B, int ty, int tx) {
#pragma unroll 8
  for (int k = 0; k < T; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) av[r] = A[(ty + 16 * r) * TS + k];
#pragma unroll
    for (int q = 0; q < 4; ++q) bv[q] = B[(tx + 16 * q) * TS + k];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
  }
}

// acc[r][q] += sum_k A[row r][k] * B[k][col q]   (A B)
__device__ __forceinline__ void prod_nn(float acc[4][4], const float* A,
                                        const float* B, int ty, int tx) {
#pragma unroll 8
  for (int k = 0; k < T; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) av[r] = A[(ty + 16 * r) * TS + k];
#pragma unroll
    for (int q = 0; q < 4; ++q) bv[q] = B[k * TS + tx + 16 * q];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
  }
}

// acc[r][q] += sum_k A[k][col r] * B[k][col q]   (A^T B)
__device__ __forceinline__ void prod_tn(float acc[4][4], const float* A,
                                        const float* B, int ty, int tx) {
#pragma unroll 8
  for (int k = 0; k < T; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) av[r] = A[k * TS + ty + 16 * r];
#pragma unroll
    for (int q = 0; q < 4; ++q) bv[q] = B[k * TS + tx + 16 * q];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
  }
}

__device__ __forceinline__ void zero(float acc[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
}

// O[row][o0 + col] += scale(row) * acc for rows < 64, o0 + col < cols
__device__ __forceinline__ void add_to(float* O, int ostride, int o0, int cols,
                                       const float acc[4][4], const float* scale,
                                       int ty, int tx) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = ty + 16 * r;
    const float s = scale != nullptr ? scale[row] : 1.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = o0 + tx + 16 * q;
      if (col < cols) O[row * ostride + col] += s * acc[r][q];
    }
  }
}

// What a chunk-pass block reads: one (batch, head, chunk)'s operands
struct Chunk {
  const float* x;      // x + b x_sb + c0 x_ss + h P (rows: positions)
  const float* dt;     // dt + (b S + c0) H + h (row stride H)
  const float* bm;     // B + b b_sb + c0 b_ss + g N
  const float* cm;     // C + b c_sb + c0 c_ss + g N
  const float* dy;     // dy + ((b S + c0) H + h) P (row stride H P)
  long long x_ss, b_ss, c_ss, dy_ss, dt_ss;
  int len, N, P;
};

// The pair (I tile at i0, J tile at j0): M = C_I B_J^T and Gm = dy_I xbar_J^T
// into registers, then Wt = M o E and Zt = Gm o E (E masked to j <= i < len)
// into shared memory; rowp[r] = the thread's part of its rows' sums of R =
// W o Gm, colp[q] its part of its columns' sums.
__device__ __forceinline__ void pair_tiles(const Chunk& ch, const float* cums,
                                           int i0, int j0, float* D1, float* D2,
                                           float* Wt, float* Zt, float rowp[4],
                                           float colp[4], int tid, int ty, int tx) {
  const int ri = min(T, ch.len - i0), rj = min(T, ch.len - j0);
  float m[4][4], gm[4][4];
  zero(m);
  zero(gm);
  for (int k0 = 0; k0 < ch.N; k0 += T) {
    __syncthreads();
    load_slab(D1, ch.cm + i0 * ch.c_ss, ch.c_ss, ri, ch.N, k0, nullptr, 0, tid);
    load_slab(D2, ch.bm + j0 * ch.b_ss, ch.b_ss, rj, ch.N, k0, nullptr, 0, tid);
    __syncthreads();
    prod_nt(m, D1, D2, ty, tx);
  }
  for (int k0 = 0; k0 < ch.P; k0 += T) {
    __syncthreads();
    load_slab(D1, ch.dy + i0 * ch.dy_ss, ch.dy_ss, ri, ch.P, k0, nullptr, 0, tid);
    load_slab(D2, ch.x + j0 * ch.x_ss, ch.x_ss, rj, ch.P, k0,
              ch.dt + j0 * ch.dt_ss, ch.dt_ss, tid);
    __syncthreads();
    prod_nt(gm, D1, D2, ty, tx);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + tx + 16 * q;
      // mask before exp: only j <= i < len is ever exponentiated
      const float e = (j <= i && i < ch.len) ? expf(cums[i] - cums[j]) : 0.f;
      const float w = m[r][q] * e;
      Wt[(ty + 16 * r) * TS + tx + 16 * q] = w;
      Zt[(ty + 16 * r) * TS + tx + 16 * q] = gm[r][q] * e;
      const float rv = w * gm[r][q];
      rowp[r] += rv;
      colp[q] += rv;
    }
  }
  __syncthreads();        // Wt and Zt are complete
}

// the sum of v over the 16 lanes tx = 0..15 of a half-warp, in a fixed tree
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

size_t chunk_smem_floats(int Q) {
  return (size_t)Q + 4 * (size_t)T * TS + 16 * T + 2 * T;
}

// ---------------------------------------------------------------------------
// 4. The column pass, grid (ceil(Q / 64), nc, B * H): tile J of the chunk.
// Shared: cums [Q], D1, D2, Wt, Zt [64][65], column partials [16][64],
// colacc [64], vacc [64], dX [64][P], dBa [64][N].
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
ssd_bwd_col_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ bm, const float* __restrict__ cm,
                   const float* __restrict__ dy, const float* __restrict__ cums_g,
                   const float* __restrict__ ds_out, float* __restrict__ dx,
                   float* __restrict__ dbh, float* __restrict__ colpart,
                   float* __restrict__ vout, float* __restrict__ xdx, int S,
                   int H, int G, int N, int P, int Q, int nc, long long x_sb,
                   long long x_ss, long long b_sb, long long b_ss, long long c_sb,
                   long long c_ss) {
  const int jt = blockIdx.x, c = blockIdx.y, bh = blockIdx.z;
  const int b = bh / H, h = bh % H, g = h / (H / G);
  const int c0 = c * Q, len = min(Q, S - c0), j0 = jt * T;
  if (j0 >= len) return;
  extern __shared__ float smem[];
  float* cums = smem;                  // [Q]
  float* D1 = cums + Q;
  float* D2 = D1 + T * TS;
  float* Wt = D2 + T * TS;
  float* Zt = Wt + T * TS;
  float* cp = Zt + T * TS;             // [16][64]
  float* colacc = cp + 16 * T;         // [64]
  float* vacc = colacc + T;            // [64]
  float* dX = vacc + T;                // [64][P]
  float* dBa = dX + T * P;             // [64][N]
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  const Chunk ch{x + b * x_sb + c0 * x_ss + (long long)h * P,
                 dt + ((size_t)b * S + c0) * H + h,
                 bm + b * b_sb + c0 * b_ss + (long long)g * N,
                 cm + b * c_sb + c0 * c_ss + (long long)g * N,
                 dy + (((size_t)b * S + c0) * H + h) * P,
                 x_ss, b_ss, c_ss, (long long)H * P, (long long)H, len, N, P};
  const float* cg = cums_g + ((size_t)bh * nc + c) * Q;
  for (int e = tid; e < Q; e += THREADS) cums[e] = cg[e];
  for (int e = tid; e < T * P; e += THREADS) dX[e] = 0.f;
  for (int e = tid; e < T * N; e += THREADS) dBa[e] = 0.f;
  if (tid < T) colacc[tid] = 0.f;
  __syncthreads();
  const float last = cums[Q - 1];

  float acc[4][4];
  for (int i0 = j0; i0 < len; i0 += T) {
    float rowp[4] = {0.f, 0.f, 0.f, 0.f}, colp[4] = {0.f, 0.f, 0.f, 0.f};
    pair_tiles(ch, cums, i0, j0, D1, D2, Wt, Zt, rowp, colp, tid, ty, tx);
#pragma unroll
    for (int q = 0; q < 4; ++q) cp[ty * T + tx + 16 * q] = colp[q];
    const int ri = min(T, len - i0);
    // dxbar_J += W^T dy_I, a 64-column slab of P at a time
    for (int p0 = 0; p0 < P; p0 += T) {
      load_slab(D1, ch.dy + i0 * ch.dy_ss, ch.dy_ss, ri, P, p0, nullptr, 0, tid);
      __syncthreads();
      zero(acc);
      prod_tn(acc, Wt, D1, ty, tx);
      add_to(dX, P, p0, P, acc, nullptr, ty, tx);
      __syncthreads();
    }
    // dB_J += Z^T C_I
    for (int n0 = 0; n0 < N; n0 += T) {
      load_slab(D1, ch.cm + i0 * c_ss, c_ss, ri, N, n0, nullptr, 0, tid);
      __syncthreads();
      zero(acc);
      prod_tn(acc, Zt, D1, ty, tx);
      add_to(dBa, N, n0, N, acc, nullptr, ty, tx);
      __syncthreads();
    }
    if (tid < T) {                     // the column sums of R, in order ty
      float s = 0.f;
      for (int k = 0; k < 16; ++k) s += cp[k * T + tid];
      colacc[tid] += s;
    }
  }

  // the dS_out terms, with w_j = e^(last - cums_j) (Wt[0..63] holds w)
  const int rj = min(T, len - j0);
  const float* dso = ds_out + ((size_t)bh * nc + c) * N * P;
  __syncthreads();
  if (tid < T) Wt[tid] = tid < rj ? expf(last - cums[j0 + tid]) : 0.f;
  // dxbar_J += w (B_J dS_out)
  for (int p0 = 0; p0 < P; p0 += T) {
    zero(acc);
    for (int n0 = 0; n0 < N; n0 += T) {
      __syncthreads();
      load_slab(D1, ch.bm + j0 * b_ss, b_ss, rj, N, n0, nullptr, 0, tid);
      load_slab(D2, dso + (size_t)n0 * P, P, min(T, N - n0), P, p0, nullptr, 0, tid);
      __syncthreads();
      prod_nn(acc, D1, D2, ty, tx);
    }
    add_to(dX, P, p0, P, acc, Wt, ty, tx);
  }
  // u = xbar_J dS_out^T; dB_J += w u; v_j = w_j B_j . u_j
  float vpart[4] = {0.f, 0.f, 0.f, 0.f};
  for (int n0 = 0; n0 < N; n0 += T) {
    zero(acc);
    for (int p0 = 0; p0 < P; p0 += T) {
      __syncthreads();
      load_slab(D1, ch.x + j0 * ch.x_ss, ch.x_ss, rj, P, p0,
                ch.dt + (long long)j0 * H, H, tid);
      load_slab(D2, dso + (size_t)n0 * P, P, min(T, N - n0), P, p0, nullptr, 0, tid);
      __syncthreads();
      prod_nt(acc, D1, D2, ty, tx);
    }
    add_to(dBa, N, n0, N, acc, Wt, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = ty + 16 * r;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = n0 + tx + 16 * q;
        if (j < rj && n < N) vpart[r] += ch.bm[(j0 + j) * b_ss + n] * acc[r][q];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float v = sum16(vpart[r]);
    if (tx == 0) vacc[ty + 16 * r] = v * Wt[ty + 16 * r];
  }
  __syncthreads();

  // dx = dt dxbar, x . dxbar, dB per head, the column part of dcums and v
  const size_t srow = (size_t)b * S + c0 + j0;
  for (int e = tid; e < rj * P; e += THREADS) {
    const int j = e / P, p = e % P;
    dx[((srow + j) * H + h) * P + p] = ch.dt[(long long)(j0 + j) * H] * dX[j * P + p];
  }
  for (int e = tid; e < rj * N; e += THREADS) {
    const int j = e / N, n = e % N;
    dbh[((srow + j) * H + h) * N + n] = dBa[j * N + n];
  }
  if (tid < rj) {
    float s = 0.f;
    for (int p = 0; p < P; ++p) s = fmaf(ch.x[(j0 + tid) * ch.x_ss + p], dX[tid * P + p], s);
    const size_t o = (size_t)bh * nc * Q + (size_t)c * Q + j0 + tid;
    xdx[o] = s;
    vout[o] = vacc[tid];
    colpart[o] = colacc[tid] + vacc[tid];
  }
}

// ---------------------------------------------------------------------------
// 5. The row pass, grid (ceil(Q / 64), nc, B * H): tile I of the chunk.
// Shared: cums [Q], D1, D2, Wt, Zt [64][65], rowacc [64], tacc [64],
// dCa [64][N].
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
ssd_bwd_row_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ bm, const float* __restrict__ cm,
                   const float* __restrict__ dy, const float* __restrict__ cums_g,
                   const float* __restrict__ s_in, float* __restrict__ dch,
                   float* __restrict__ rowpart, int S, int H, int G, int N,
                   int P, int Q, int nc, long long x_sb, long long x_ss,
                   long long b_sb, long long b_ss, long long c_sb, long long c_ss) {
  const int it = blockIdx.x, c = blockIdx.y, bh = blockIdx.z;
  const int b = bh / H, h = bh % H, g = h / (H / G);
  const int c0 = c * Q, len = min(Q, S - c0), i0 = it * T;
  if (i0 >= len) return;
  extern __shared__ float smem[];
  float* cums = smem;
  float* D1 = cums + Q;
  float* D2 = D1 + T * TS;
  float* Wt = D2 + T * TS;
  float* Zt = Wt + T * TS;
  float* rowacc = Zt + T * TS;         // [64]
  float* tacc = rowacc + T;            // [64]
  float* dCa = tacc + T;               // [64][N]
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  const Chunk ch{x + b * x_sb + c0 * x_ss + (long long)h * P,
                 dt + ((size_t)b * S + c0) * H + h,
                 bm + b * b_sb + c0 * b_ss + (long long)g * N,
                 cm + b * c_sb + c0 * c_ss + (long long)g * N,
                 dy + (((size_t)b * S + c0) * H + h) * P,
                 x_ss, b_ss, c_ss, (long long)H * P, (long long)H, len, N, P};
  const float* cg = cums_g + ((size_t)bh * nc + c) * Q;
  for (int e = tid; e < Q; e += THREADS) cums[e] = cg[e];
  for (int e = tid; e < T * N; e += THREADS) dCa[e] = 0.f;
  __syncthreads();

  float acc[4][4];
  float rows[4] = {0.f, 0.f, 0.f, 0.f};
  for (int j0 = 0; j0 <= i0; j0 += T) {
    float rowp[4] = {0.f, 0.f, 0.f, 0.f}, colp[4] = {0.f, 0.f, 0.f, 0.f};
    pair_tiles(ch, cums, i0, j0, D1, D2, Wt, Zt, rowp, colp, tid, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) rows[r] += sum16(rowp[r]);
    const int rj = min(T, len - j0);
    // dC_I += Z B_J
    for (int n0 = 0; n0 < N; n0 += T) {
      load_slab(D1, ch.bm + j0 * b_ss, b_ss, rj, N, n0, nullptr, 0, tid);
      __syncthreads();
      zero(acc);
      prod_nn(acc, Zt, D1, ty, tx);
      add_to(dCa, N, n0, N, acc, nullptr, ty, tx);
      __syncthreads();
    }
  }

  // the S_in terms: w = dy_I S_in^T; dC_I += e^cums w; t_i = e^cums_i C_i . w_i
  const int ri = min(T, len - i0);
  const float* sin_c = s_in + ((size_t)bh * nc + c) * N * P;
  if (tid < T) Wt[tid] = tid < ri ? expf(cums[i0 + tid]) : 0.f;
  float tpart[4] = {0.f, 0.f, 0.f, 0.f};
  for (int n0 = 0; n0 < N; n0 += T) {
    zero(acc);
    for (int p0 = 0; p0 < P; p0 += T) {
      __syncthreads();
      load_slab(D1, ch.dy + i0 * ch.dy_ss, ch.dy_ss, ri, P, p0, nullptr, 0, tid);
      load_slab(D2, sin_c + (size_t)n0 * P, P, min(T, N - n0), P, p0, nullptr, 0, tid);
      __syncthreads();
      prod_nt(acc, D1, D2, ty, tx);
    }
    add_to(dCa, N, n0, N, acc, Wt, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty + 16 * r;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = n0 + tx + 16 * q;
        if (i < ri && n < N) tpart[r] += ch.cm[(i0 + i) * c_ss + n] * acc[r][q];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float t = sum16(tpart[r]);
    if (tx == 0) {
      rowacc[ty + 16 * r] = rows[r];
      tacc[ty + 16 * r] = t * Wt[ty + 16 * r];
    }
  }
  __syncthreads();

  const size_t srow = (size_t)b * S + c0 + i0;
  for (int e = tid; e < ri * N; e += THREADS) {
    const int i = e / N, n = e % N;
    dch[((srow + i) * H + h) * N + n] = dCa[i * N + n];
  }
  if (tid < ri)
    rowpart[(size_t)bh * nc * Q + (size_t)c * Q + i0 + tid] = rowacc[tid] + tacc[tid];
}

// ---------------------------------------------------------------------------
// 6. grid (nc, B * H): dcums_i = rowpart_i - colpart_i, the last row's
// sum_j v_j + e^last <S_in, dS_out> added to every position, d(dtA) its
// reverse cumsum (warp 0: runs of Q / 32 a lane, then a suffix scan across
// lanes), ddt = A d(dtA) + x . dxbar, and the chunk's part of dA.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
ssd_bwd_finish_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                      const float* __restrict__ cums, const float* __restrict__ s_in,
                      const float* __restrict__ ds_out,
                      const float* __restrict__ rowpart,
                      const float* __restrict__ colpart,
                      const float* __restrict__ vin, const float* __restrict__ xdx,
                      float* __restrict__ ddt, float* __restrict__ dapart, int S,
                      int H, int N, int P, int Q, int nc) {
  const int c = blockIdx.x, bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int c0 = c * Q, len = min(Q, S - c0);
  extern __shared__ float smem[];
  float* dc = smem;                    // [Q]
  float* red = dc + Q;                 // [THREADS]
  const int tid = threadIdx.x;
  const size_t base = (size_t)bh * nc * Q + (size_t)c * Q;
  const size_t sbase = ((size_t)bh * nc + c) * N * P;

  float dot = 0.f, vs = 0.f;
  for (int e = tid; e < N * P; e += THREADS) dot = fmaf(s_in[sbase + e], ds_out[sbase + e], dot);
  for (int i = tid; i < len; i += THREADS) vs += vin[base + i];
  for (int i = tid; i < Q; i += THREADS)
    dc[i] = i < len ? rowpart[base + i] - colpart[base + i] : 0.f;
  red[tid] = dot;
  __syncthreads();
  for (int off = THREADS / 2; off > 0; off >>= 1) {
    if (tid < off) red[tid] += red[tid + off];
    __syncthreads();
  }
  dot = red[0];
  __syncthreads();
  red[tid] = vs;
  __syncthreads();
  for (int off = THREADS / 2; off > 0; off >>= 1) {
    if (tid < off) red[tid] += red[tid + off];
    __syncthreads();
  }
  const float lastterm = red[0] + expf(cums[((size_t)bh * nc + c) * Q + Q - 1]) * dot;

  if (tid < 32) {
    const int per = (Q + 31) / 32, s0 = tid * per, s1 = min(Q, s0 + per);
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
__global__ void __launch_bounds__(THREADS)
ssd_bwd_sum_kernel(const float* __restrict__ dbh, const float* __restrict__ dch,
                   const float* __restrict__ dapart, float* __restrict__ db,
                   float* __restrict__ dcg, float* __restrict__ da, int B, int S,
                   int H, int G, int N, int nc) {
  const size_t idx = (size_t)blockIdx.x * THREADS + threadIdx.x;
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

size_t state_smem_bytes(int N) {
  return sizeof(float) * ((size_t)T * (N + 1) + (size_t)T * PT + T);
}
size_t col_smem_bytes(int N, int P, int Q) {
  return sizeof(float) * (chunk_smem_floats(Q) + (size_t)T * (P + N));
}
size_t row_smem_bytes(int N, int Q) {
  return sizeof(float) * (chunk_smem_floats(Q) + (size_t)T * N);
}

}  // namespace

// The SSD's VJP.  Inputs as ssd_chunk_fwd's float32 instance (x, B, C with
// strides in elements; dt, A, state_in contiguous; state_in may be null),
// dy [B, S, H, P] and dstate [B, H, N, P] (or null: no cotangent of the
// final state) contiguous; outputs dx [B, S, H, P], ddt [B, S, H], dA [H],
// dB and dC [B, S, G, N], dstate_in [B, H, N, P] (null when state_in is);
// ws0..ws9 the scratch of kernels/ssd_chunk.py::_bwd_workspace.  Returns
// the cudaError_t of the launches (0 on success).
extern "C" int ssd_chunk_bwd(const void* x, const void* dt, const void* A,
                             const void* bm, const void* cm, const void* state_in,
                             const void* dy, const void* dstate, void* dx,
                             void* ddt, void* dA, void* dB, void* dC,
                             void* dstate_in, void* ws0, void* ws1, void* ws2,
                             void* ws3, void* ws4, void* ws5, void* ws6,
                             void* ws7, void* ws8, void* ws9, int B, int S,
                             int H, int G, int N, int P, int Q, int nc,
                             long long x_sb, long long x_ss, long long b_sb,
                             long long b_ss, long long c_sb, long long c_ss,
                             void* stream) {
  if (B <= 0 || S <= 0 || G <= 0 || H % G != 0 || N <= 0 || N > 16 * MAXK ||
      P <= 0 || Q <= 0 || Q > S || Q > 1024 || nc != (S + Q - 1) / Q)
    return cudaErrorInvalidValue;
  const size_t s_state = state_smem_bytes(N), s_col = col_smem_bytes(N, P, Q),
               s_row = row_smem_bytes(N, Q),
               s_fin = sizeof(float) * ((size_t)Q + THREADS);
  if (s_col > 232448 || s_row > 232448) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A);
  const float* bf = static_cast<const float*>(bm);
  const float* cf = static_cast<const float*>(cm);
  const float* dyf = static_cast<const float*>(dy);
  float* cums = static_cast<float*>(ws0);
  float* s_in = static_cast<float*>(ws1);
  float* dso = static_cast<float*>(ws2);
  float* dbh = static_cast<float*>(ws3);
  float* dch = static_cast<float*>(ws4);
  float* rowpart = static_cast<float*>(ws5);
  float* colpart = static_cast<float*>(ws6);
  float* vv = static_cast<float*>(ws7);
  float* xdx = static_cast<float*>(ws8);
  float* dapart = static_cast<float*>(ws9);
  const int BH = B * H;
  cudaError_t err;

  ssd_bwd_cums_kernel<<<dim3(nc, BH), 32, 0, st>>>(dtf, af, cums, S, H, Q, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const dim3 gs((P + PT - 1) / PT, BH);
  if ((err = cudaFuncSetAttribute(ssd_bwd_state_kernel<false>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)s_state)) != cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(ssd_bwd_state_kernel<true>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)s_state)) != cudaSuccess)
    return err;
  ssd_bwd_state_kernel<false><<<gs, THREADS, s_state, st>>>(
      xf, dtf, bf, dyf, cums, static_cast<const float*>(state_in), s_in, nullptr,
      S, H, G, N, P, Q, nc, x_sb, x_ss, b_sb, b_ss);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_state_kernel<true><<<gs, THREADS, s_state, st>>>(
      xf, dtf, cf, dyf, cums, static_cast<const float*>(dstate), dso,
      static_cast<float*>(dstate_in), S, H, G, N, P, Q, nc, x_sb, x_ss, c_sb,
      c_ss);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const dim3 gc((Q + T - 1) / T, nc, BH);
  if ((err = cudaFuncSetAttribute(ssd_bwd_col_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)s_col)) != cudaSuccess)
    return err;
  ssd_bwd_col_kernel<<<gc, THREADS, s_col, st>>>(
      xf, dtf, bf, cf, dyf, cums, dso, static_cast<float*>(dx), dbh, colpart, vv,
      xdx, S, H, G, N, P, Q, nc, x_sb, x_ss, b_sb, b_ss, c_sb, c_ss);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = cudaFuncSetAttribute(ssd_bwd_row_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)s_row)) != cudaSuccess)
    return err;
  ssd_bwd_row_kernel<<<gc, THREADS, s_row, st>>>(
      xf, dtf, bf, cf, dyf, cums, s_in, dch, rowpart, S, H, G, N, P, Q, nc, x_sb,
      x_ss, b_sb, b_ss, c_sb, c_ss);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  ssd_bwd_finish_kernel<<<dim3(nc, BH), THREADS, s_fin, st>>>(
      dtf, af, cums, s_in, dso, rowpart, colpart, vv, xdx,
      static_cast<float*>(ddt), dapart, S, H, N, P, Q, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t total = (size_t)B * S * G * N;
  const size_t work = total > (size_t)H ? total : (size_t)H;
  ssd_bwd_sum_kernel<<<(unsigned)((work + THREADS - 1) / THREADS), THREADS, 0, st>>>(
      dbh, dch, dapart, static_cast<float*>(dB), static_cast<float*>(dC),
      static_cast<float*>(dA), B, S, H, G, N, nc);
  return cudaGetLastError();
}
