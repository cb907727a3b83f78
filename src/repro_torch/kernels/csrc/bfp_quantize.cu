// Standalone BFP block formatting for Hopper (sm_90a), paper eq. 1:
// f32 x [M, K] -> int8 mantissas [M, K] + int32 block exponents
// [M, ceil(K / bk)], one block per (row, bk-wide K-tile).
//
// Replaces bfp_quantize_pallas (repro/kernels/bfp_quantize.py, body
// _bfp_quantize_kernel), the offline formatting of a weight matrix into
// int8 + exponent sidecar.  Per block, exactly the Pallas kernel's rules:
//   e    = exponent field of the block's amax - 127 (a subnormal amax
//          gives -127, inf gives 128); a block whose amax is not > 0 (all
//          zero, or holding a NaN) gets e = -126;
//   step = 2^(e - (bits - 2)), exact;
//   m    = clip(round_half_even(x / step), +-(2^(bits-1) - 1)), stored
//          as int8 the way XLA converts: saturated to [-128, 127], NaN
//          to 0 (so for bits > 8 the int8 mantissa saturates).
// Unlike the GEMM tile kernel, a NaN block is NOT zeroed here: its step
// is the -126 block's and its other elements saturate, as in the Pallas
// kernel.
//
// x / step: a step is a power of two, so x * 2^-s rounds exactly as the
// IEEE division whenever 2^-s is a normal float (|s| <= 126); otherwise
// (the -126 blocks' subnormal step) __fdiv_rn.  -fmad=false (the build
// flags) keeps every float op rounding on its own.
//
// What bounds it on this card: bytes.  It reads 4 B and writes 1 B per
// element (+4 B per block) and does a handful of operations per element,
// far below the H100's operations-per-byte balance, so its floor is
// 5 B/element at 3.35 TB/s.  Design: one warp per block, lanes on
// consecutive K (coalesced loads), the amax as an unsigned max over the
// |x| bit patterns (orders finite values and inf correctly and puts a
// NaN above inf) reduced with warp shuffles, then a second pass over the
// same (L1/L2-resident) block to quantize.  A ragged last K-tile just
// ends early: zero padding never changes a block's amax, so the outputs
// equal those of the padded Pallas call.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;                 // blocks (warps) per thread block
constexpr int ZERO_BLOCK_EXP = -126;
constexpr unsigned INF_BITS = 0x7F800000u;

// Exact float32 2^e (repro.core.bfp.pow2).
__device__ __forceinline__ float pow2i(int e) {
  if (e < -149) return 0.0f;
  if (e > 127) return __int_as_float(0x7F800000);
  if (e >= -126) return __int_as_float((e + 127) << 23);
  return __int_as_float(1 << (e + 149));
}

__global__ void __launch_bounds__(WARPS * 32)
bfp_quantize_kernel(const float* __restrict__ x, int8_t* __restrict__ m,
                    int* __restrict__ e_out, int M, int K, int bk, int bits,
                    long long n_blocks) {
  const int lane = threadIdx.x & 31;
  const int n_t = (K + bk - 1) / bk;
  const int lim = (1 << (bits - 1)) - 1;   // bits in [2, 24]
  const long long stride = (long long)gridDim.x * WARPS;
  for (long long blk = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
       blk < n_blocks; blk += stride) {
    const long long row = blk / n_t;
    const int t = (int)(blk - row * n_t);
    const int k0 = t * bk;
    const int kend = min(k0 + bk, K);
    const float* xr = x + row * (long long)K;

    unsigned amax = 0u;
    for (int k = k0 + lane; k < kend; k += 32)
      amax = max(amax, __float_as_uint(fabsf(xr[k])));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = max(amax, __shfl_xor_sync(0xFFFFFFFFu, amax, off));

    // amax > 0: a positive, non-NaN bit pattern
    const int e = (amax > 0u && amax <= INF_BITS)
                      ? (int)((amax >> 23) & 0xFFu) - 127
                      : ZERO_BLOCK_EXP;
    const int s = e - (bits - 2);
    const float step = pow2i(s);
    const bool recip = s >= -126 && s <= 126;
    const float inv = recip ? pow2i(-s) : 0.0f;

    int8_t* mr = m + row * (long long)K;
    for (int k = k0 + lane; k < kend; k += 32) {
      const float v = xr[k];
      const float q = recip ? __fmul_rn(v, inv) : __fdiv_rn(v, step);
      // half-to-even; saturates to int32, NaN -> 0
      int mi = __float2int_rn(q);
      mi = min(max(mi, -lim), lim);
      mr[k] = (int8_t)min(max(mi, -128), 127);
    }
    if (lane == 0) e_out[row * n_t + t] = e;
  }
}

}  // namespace

extern "C" int bfp_quantize_launch(const void* x, void* m, void* e, int M,
                                   int K, int bk, int bits, void* stream) {
  const long long n_blocks = (long long)M * ((K + bk - 1) / bk);
  if (n_blocks == 0) return 0;
  const long long want = (n_blocks + WARPS - 1) / WARPS;
  const int grid = (int)(want < 65535LL * 32 ? want : 65535LL * 32);
  bfp_quantize_kernel<<<grid, WARPS * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(m),
      static_cast<int*>(e), M, K, bk, bits, n_blocks);
  return (int)cudaGetLastError();
}
