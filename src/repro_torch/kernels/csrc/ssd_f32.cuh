// Float32 building blocks of K4 (csrc/ssd_chunk.cu) and of its backward
// (csrc/ssd_chunk_bwd.cu): shared-memory tile loads by cp.async, the
// mma.sync fragments K4's products read, each split by tf32x3.cuh into
// big + small TF32 parts (3xTF32: float32 accuracy on the tensor cores), and
// the two kernels that the forward and the backward both launch (the
// backward's under the names ssd_bwd_cb_kernel and ssd_bwd_state_kernel),
// defined in ssd_chunk.cu:
//  - ssd_cb_kernel: C B^T once per (batch, group, chunk), on the 64 x 64
//    tiles on and below the diagonal, into scratch [B*G, nc, QP, QP];
//  - ssd_state_kernel: the chunk-parallel state pass.  Per (batch * head,
//    chunk, 64 columns of P) a block scans cums = cumsum(dt A), computes the
//    chunk's own [N, 64] contribution sum_j U_j^T (om_j V_j) and the last
//    block of each (batch * head, P tile) to finish (a release-acquire
//    ticket) carries the sum across the chunks in float32.  Forward (rev 0):
//    U = B, V = x, om_j = dt_j e^(last - cums_j), the carry S_in(c + 1) =
//    S_in(c) e^last_c + S^_c from state_in (or 0).  Reverse (rev 1): U = C,
//    V = dy, om_i = e^cums_i, dS_out(c - 1) = dS_out(c) e^last_c + dS^_c
//    from dS_final (or 0), ending at d state_in.
//
// Row strides of the shared tiles follow how their fragments read them, so
// the 32 lanes of a fragment load hit 32 banks: along rows (frag_a,
// frag_b_t, and frag_b_perm's rows 2t, 2t + 1) a stride of 4 mod 32 floats;
// down columns (frag_a_t, frag_b) or as accumulators (a float2 at (g, 2t))
// 8 mod 32.
#pragma once

#include <stdint.h>

#include <cuda_runtime.h>

#include "sm90.cuh"
#include "tf32x3.cuh"

namespace repro_torch {
namespace ssd_f32 {

using tf32x3::Split;

constexpr int T = 64;    // rows of a tile, and the columns of a P tile
constexpr int H2 = 32;   // rows of a streamed half tile

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }
__host__ __device__ constexpr int ld4(int w) { return round_up(w, 32) + 4; }
__host__ __device__ constexpr int ld8(int w) { return round_up(w, 32) + 8; }

// Rows [0, R) and columns [0, W) (W % 4 == 0) of a row-major float matrix
// into shared memory at dst (row stride lds floats), by nthr threads: row r
// is src + r * ldg, valid if r < rows; column k is valid if k < cols; the
// rest is zero.  vec: 16-byte cp.async (src and ldg 16-byte aligned, cols
// % 4 == 0); else 4-byte cp.async, element by element.  The caller commits.
__device__ __forceinline__ void load_tile(float* dst, int lds, const float* src,
                                          long long ldg, int R, int W, int rows,
                                          int cols, bool vec, int tid, int nthr) {
  if (vec) {
    const int CH = W >> 2;
    for (int e = tid; e < R * CH; e += nthr) {
      const int r = e / CH, k = 4 * (e - r * CH);
      const bool ok = r < rows && k < cols;
      sm90::cp_async16(sm90::smem_addr(dst + r * lds + k), src + (ok ? r * ldg + k : 0), ok);
    }
  } else {
    for (int e = tid; e < R * W; e += nthr) {
      const int r = e / W, k = e - r * W;
      const bool ok = r < rows && k < cols;
      sm90::cp_async4(sm90::smem_addr(dst + r * lds + k), src + (ok ? r * ldg + k : 0), ok);
    }
  }
}

// Fragments of m16n8k8 (g = lane / 4, t = lane % 4; tf32x3.cuh lists them).
// A (16 x 8) = tile rows r0.., columns c0.. (along rows), row g scaled by
// s0 and row g + 8 by s1
__device__ __forceinline__ Split<4> frag_a(const float* tile, int ld, int r0, int c0,
                                           int lane, float s0 = 1.f, float s1 = 1.f) {
  const int g = lane >> 2, t = lane & 3;
  const float* p = tile + (r0 + g) * ld + c0 + t;
  const float x[4] = {p[0] * s0, p[8 * ld] * s1, p[4] * s0, p[8 * ld + 4] * s1};
  return tf32x3::split(x);
}

// A = tile^T: A[m][k] = tile[k0 + k][m0 + m] (down columns)
__device__ __forceinline__ Split<4> frag_a_t(const float* tile, int ld, int m0, int k0,
                                             int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* p = tile + (k0 + t) * ld + m0 + g;
  const float x[4] = {p[0], p[8], p[4 * ld], p[4 * ld + 8]};
  return tf32x3::split(x);
}

// B (8 x 8) = tile[k0 + k][n0 + n] (down columns), row k scaled by s[k0 + k]
// (s null: 1)
__device__ __forceinline__ Split<2> frag_b(const float* tile, int ld, int k0, int n0,
                                           int lane, const float* s = nullptr) {
  const int g = lane >> 2, t = lane & 3;
  const float* p = tile + (k0 + t) * ld + n0 + g;
  float x[2] = {p[0], p[4 * ld]};
  if (s != nullptr) {
    x[0] *= s[k0 + t];
    x[1] *= s[k0 + t + 4];
  }
  return tf32x3::split(x);
}

// B = tile^T: B[k][n] = tile[n0 + n][k0 + k] (along rows), scaled by sn (the
// scale of this lane's row n0 + g)
__device__ __forceinline__ Split<2> frag_b_t(const float* tile, int ld, int n0, int k0,
                                             int lane, float sn = 1.f) {
  const int g = lane >> 2, t = lane & 3;
  const float* p = tile + (n0 + g) * ld + k0 + t;
  const float x[2] = {p[0] * sn, p[4] * sn};
  return tf32x3::split(x);
}

// B = tile[k0 + k][n0 + n] with the permuted reduction slots of an A
// fragment taken from an accumulator (tf32x3::acc_as_a): slot t reads row
// k0 + 2t, slot t + 4 row k0 + 2t + 1; row k scaled by s[k0 + k] (s null: 1)
__device__ __forceinline__ Split<2> frag_b_perm(const float* tile, int ld, int k0,
                                                int n0, int lane,
                                                const float* s = nullptr) {
  const int g = lane >> 2, t = lane & 3;
  const float* p = tile + (k0 + 2 * t) * ld + n0 + g;
  float x[2] = {p[0], p[ld]};
  if (s != nullptr) {
    x[0] *= s[k0 + 2 * t];
    x[1] *= s[k0 + 2 * t + 1];
  }
  return tf32x3::split(x);
}

__device__ __forceinline__ void zero(float (&a)[4]) { a[0] = a[1] = a[2] = a[3] = 0.f; }

// Launchers of the shared kernels (ssd_chunk.cu); both return the
// cudaError_t of the launch.  Pointers as ssd_chunk_fwd / ssd_chunk_bwd
// document them; QP = Q rounded up to 64; vec: every view of B, C and x (or
// dy) 16-byte aligned with strides, N and P multiples of 4.
// bwd: launch the backward's instances (ssd_bwd_cb_kernel,
// ssd_bwd_state_kernel), the same code under names of their own.
cudaError_t launch_cb(int bwd, const float* bm, const float* cm, float* cb, int B,
                      int S, int G, int N, int Q, int QP, int nc, long long b_sb,
                      long long b_ss, long long c_sb, long long c_ss, int vec,
                      cudaStream_t stream);

// u, v: B and x (rev 0) or C and dy (rev 1), with their strides; init:
// state_in or dS_final (or null); hat: the chunks' own contributions [B*H,
// nc, N, P]; out: S_in or dS_out per chunk (may be hat: written in place);
// fin: the final state or d state_in (or null); cums [B*H, nc, QP] (or
// null); last [B*H, nc]; counters: B*H*ceil(P / 64) zeroed tickets, left at
// zero.
cudaError_t launch_state(int bwd, int rev, const float* u, const float* v,
                         const float* dt, const float* A, const float* init, float* hat,
                         float* out, float* fin, float* cums, float* last,
                         unsigned* counters, int B, int S, int H, int G, int N, int P,
                         int Q, int QP, int nc, long long u_sb, long long u_ss,
                         long long v_sb, long long v_ss, int vec, cudaStream_t stream);

}  // namespace ssd_f32
}  // namespace repro_torch
