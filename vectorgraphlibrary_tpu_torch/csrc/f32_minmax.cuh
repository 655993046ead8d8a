// f32_minmax.cuh: the one f32 min/max rule of the port's kernels
// (route_gather.cu's weight join, pull_reduce.cu's combine and join,
// scatter_combine.cu's f32 scatter). Their plain versions compute the same
// rule in ops/cuda/f32_order.py.
//
// The rule is the JAX package's on the CPU (XLA's minimum and maximum, and
// the reductions and scatters built on them): a NaN wins over any number,
// and -0.0 is below +0.0, so min(+0.0, -0.0) is -0.0 and max is +0.0. One
// NaN comes out with its own bits. Of two NaNs, the one whose bits are the
// smaller as uint32 wins (XLA leaves that choice unspecified). So min and
// max are the least and the greatest element under one total order of the
// bit patterns: both commute and associate, and a reduction or a scatter
// gives the same bits in any order of its operands, atomics included.
// fminf/fmaxf (NaN loses) and b < a ? b : a (the first of two zeros wins)
// break that.
#pragma once

#include <stdint.h>

__device__ __forceinline__ bool vgl_f32_nan_pick(float a, float b, float* r) {
  const bool na = a != a, nb = b != b;
  if (!(na || nb)) return false;
  if (na && nb)
    *r = __float_as_uint(a) <= __float_as_uint(b) ? a : b;
  else
    *r = na ? a : b;
  return true;
}

__device__ __forceinline__ float vgl_fmin(float a, float b) {
  float r;
  if (vgl_f32_nan_pick(a, b, &r)) return r;
  // equal numbers differ in their bits only as +0.0 and -0.0: the sign's
  // or is the least
  if (a == b) return __int_as_float(__float_as_int(a) | __float_as_int(b));
  return b < a ? b : a;
}

__device__ __forceinline__ float vgl_fmax(float a, float b) {
  float r;
  if (vgl_f32_nan_pick(a, b, &r)) return r;
  if (a == b) return __int_as_float(__float_as_int(a) & __float_as_int(b));
  return b > a ? b : a;
}
