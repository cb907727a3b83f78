// BFP block rules shared by the tile kernel (bfp_tile.cuh) and the int8
// mma conv core and its activation format pass (bfp_mma.cuh), so every
// kernel that block-formats in this package rounds the same way.
//
// A block of values with amax a (taken as the max of |v| bit patterns,
// which orders finite floats and inf and puts a NaN above inf) gets
//   e = floor(log2 a) from the f32 exponent field (a subnormal a gives
//       -127), step = 2^(e - (L-2)), m = clamp(rne(v / step), +-lim);
//   a block whose amax is not > 0 (all zero, or a NaN) gets step
//   2^(-126 - (L-2)) and mantissas 0.
// These are repro's kernel rules (bfp_matmul.py _make_matmul_kernel,
// bfp_conv.py _make_conv_kernel, _requant_store); they differ from
// prequant_act's frexp and from bfp_quantize's saturating and NaN rules
// on a NaN, inf or subnormal amax.
//
// v / step: a step is a power of two, so v * 2^-s is the same real
// number as v / 2^s and rounds identically whenever 2^-s is itself a
// float (|s| <= 127); only then is the reciprocal used, and __fdiv_rn
// otherwise (a subnormal step's reciprocal overflows).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bfp {

constexpr int ZERO_BLOCK_EXP = -126;

// Exact float32 2^e (repro.core.bfp.pow2): exponent field for normals,
// one mantissa bit for subnormals, +0 below 2^-149, +inf above 2^127.
__device__ __forceinline__ float pow2i(int e) {
  if (e < -149) return 0.0f;
  if (e > 127) return __int_as_float(0x7F800000);
  if (e >= -126) return __int_as_float((e + 127) << 23);
  return __int_as_float(1 << (e + 149));
}

// Block parameters from the amax bit pattern.  mode 0: zero block
// (mantissas 0); 1: multiply by the exact reciprocal; 2: IEEE divide.
__device__ __forceinline__ void block_params(unsigned amax_bits, int bits,
                                             float* step, float* inv,
                                             int* mode) {
  const float amax = __uint_as_float(amax_bits);
  if (!(amax > 0.0f)) {
    *step = pow2i(ZERO_BLOCK_EXP - (bits - 2));
    *inv = 0.0f;
    *mode = 0;
    return;
  }
  const int e = (int)((amax_bits >> 23) & 0xFFu) - 127;
  const int s = e - (bits - 2);
  *step = pow2i(s);
  if (s >= -127 && s <= 127) {
    *inv = pow2i(-s);
    *mode = 1;
  } else {
    *inv = 0.0f;
    *mode = 2;
  }
}

__device__ __forceinline__ int quant(float v, float step, float inv, int mode,
                                     int lim) {
  if (mode == 0) return 0;
  const float q = (mode == 1) ? __fmul_rn(v, inv) : __fdiv_rn(v, step);
  const int m = __float2int_rn(q);   // half-to-even; saturates, NaN -> 0
  return min(max(m, -lim), lim);
}

__device__ __forceinline__ int pack4(const int v[4]) {
  return (int)(((unsigned)v[0] & 0xFFu) | (((unsigned)v[1] & 0xFFu) << 8) |
               (((unsigned)v[2] & 0xFFu) << 16) | ((unsigned)v[3] << 24));
}

__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(fabsf(v));
}

}  // namespace bfp
