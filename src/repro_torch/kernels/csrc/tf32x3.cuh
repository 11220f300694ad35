// Float32-accurate products on the tensor cores: the 3xTF32 split with
// mma.sync.m16n8k8 (sm_80 and later, sm_90a included).
//
// A TF32 operand keeps 10 of float32's 23 mantissa bits, so one TF32 product
// is good to about 1e-3 relative.  The split writes each float32 x as
// x = big + small: big is x with its low 13 mantissa bits cleared (rounded
// toward zero), small = x - big (exact in float32) rounded to TF32, to
// nearest with ties away from zero.  The tensor core ignores an operand's
// low 13 bits, so adding half a TF32 ulp (0x1000) to small's bits rounds it
// and the hardware truncates: one LOP3, one FADD and one IADD a value (the
// recipe of CUTLASS's OpMultiplyAddFastF32).  cvt.rna.tf32.f32 would round
// big too, but it compiles on sm_90a to a guarded sequence of several
// integer and compare instructions, and the backward kernel measured about
// half as fast with it.  So
// x = big + small to about 2^-22 relative, and a b = a_s b_b + a_b b_s +
// a_b b_b to float32 accuracy (the a_s b_s term, about 2^-20 relative, is
// dropped).  The two small cross terms are accumulated first, then
// big * big, in float32.
//
// Fragments of m16n8k8 (g = lane / 4, t = lane % 4):
//   A 16 x 8, row-major: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B 8 x 8, col-major:  b0 (t, g), b1 (t + 4, g)
//   C 16 x 8:            c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// A product's reduction index may be permuted as long as A and B read it the
// same way: with reduction slot t standing for column 2t and slot t + 4 for
// 2t + 1, the accumulator of one 16 x 8 product is the A fragment of the next
// product over those 8 columns (a = c0, c2, c1, c3), with no shuffle and no
// trip through shared memory; B is then read at rows 2t and 2t + 1.
#pragma once

#include <stdint.h>

#include <cuda_runtime.h>

namespace repro_torch {
namespace tf32x3 {

// x -> (big, small), x ~= big + small, both TF32 as the tensor core reads them
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}

template <int N>
struct Split {
  uint32_t big[N];
  uint32_t small[N];
};

template <int N>
__device__ __forceinline__ Split<N> split(const float (&x)[N]) {
  Split<N> s;
#pragma unroll
  for (int i = 0; i < N; ++i) split(x[i], s.big[i], s.small[i]);
  return s;
}

// d += a b for one m16n8k8 TF32 product
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b to float32 accuracy: the cross terms first, then big * big
__device__ __forceinline__ void mma3(float (&d)[4], const Split<4>& a,
                                     const Split<2>& b) {
  mma(d, a.small, b.big);
  mma(d, a.big, b.small);
  mma(d, a.big, b.big);
}

// A fragment of rows r0 .. r0 + 15, columns c0 .. c0 + 7 of a row-major
// float tile with row stride ld
__device__ __forceinline__ Split<4> load_a(const float* tile, int ld, int r0,
                                           int c0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* p = tile + (r0 + g) * ld + c0 + t;
  const float x[4] = {p[0], p[8 * ld], p[4], p[8 * ld + 4]};
  return split(x);
}

// B fragment of an 8 x 8 block whose column n is row n0 + n of a row-major
// tile (B = tile^T: the reduction runs along the tile's rows, columns
// c0 .. c0 + 7)
__device__ __forceinline__ Split<2> load_b_t(const float* tile, int ld, int n0,
                                             int c0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* p = tile + (n0 + g) * ld + c0 + t;
  const float x[2] = {p[0], p[4]};
  return split(x);
}

// B fragment of an 8 x 8 block of a row-major tile read down its columns
// (B = tile: reduction over rows k0 .. k0 + 7, output columns n0 .. n0 + 7),
// with the permuted reduction slots (slot t = row 2t, slot t + 4 = row 2t + 1)
// that match an A fragment taken from an accumulator (acc_as_a)
__device__ __forceinline__ Split<2> load_b_perm(const float* tile, int ld, int k0,
                                                int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* p = tile + (k0 + 2 * t) * ld + n0 + g;
  const float x[2] = {p[0], p[ld]};
  return split(x);
}

// the accumulator of a 16 x 8 product as the A fragment (permuted slots) of a
// product that reduces over its 8 columns
__device__ __forceinline__ Split<4> acc_as_a(const float (&c)[4]) {
  const float x[4] = {c[0], c[2], c[1], c[3]};
  return split(x);
}

}  // namespace tf32x3
}  // namespace repro_torch
