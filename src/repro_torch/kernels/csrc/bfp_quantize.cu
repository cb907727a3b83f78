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
// These are not the rules of bfp_block.cuh (the GEMM kernels' blocks and
// their format passes): there a NaN block is zeroed and its step is the
// zero block's of the operand's L, here a NaN block is NOT zeroed (its
// step is the -126 block's and its other elements saturate, as in the
// Pallas kernel), the exponent is int32 and bits run to 24.  So this
// file takes the format passes' lane layout, not their block rules.
//
// x / step: a step is a power of two, so x * 2^-s rounds exactly as the
// IEEE division whenever 2^-s is a normal float (|s| <= 126); otherwise
// (the -126 blocks' subnormal step) __fdiv_rn.  -fmad=false (the build
// flags) keeps every float op rounding on its own.
//
// What bounds it on this card: bytes.  It reads 4 B and writes 1 B per
// element (+4 B per block) and does a handful of operations per element,
// far below the H100's operations-per-byte balance, so its floor is
// 5 B/element at 3.35 TB/s (ResNet-50's 45 weights, 25.5 M elements:
// 0.038 ms).  The weights are formatted one call each, and the small
// ones (64 x 64) are launch-latency bound, so per call the host path and
// the launch have to stay lean too (no pad copy: the wrapper hands x over
// as it is).  Two paths, chosen in bfp_quantize_launch by shape and
// alignment alone (bfp_quantize_vector_path):
//  * vector, when K % 16 == 0, bk % 16 == 0, bk <= 512 and x and m start
//    on 16 bytes: G = bk / 16 lanes per block (in a power-of-two group of
//    P >= G lanes, so 32 / P blocks a warp), 16 consecutive floats a lane
//    in four 16-byte loads held in registers, the amax over the group
//    with __shfl_xor_sync, the mantissas from the registers, one 16-byte
//    int8 store a lane and the exponent from the group's first lane.  x
//    is read from device memory once.
//  * scalar, every other shape: one warp per block, lanes on consecutive
//    K, the amax reduced with warp shuffles, then a second pass over the
//    same (L1/L2-resident) block to quantize; 4-byte loads, 1-byte stores.
// Both take the amax as an unsigned max over the |x| bit patterns (it
// orders finite values and inf and puts a NaN above inf), and both walk
// the blocks with a grid-stride loop.  A ragged last K-tile just ends
// early (K % 16 == 0 keeps a vector lane's 16 elements wholly inside or
// outside it): zero padding never changes a block's amax, so the outputs
// equal those of the padded Pallas call.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;                 // warps per thread block
constexpr int EPL = 16;                  // vector path: elements per lane
constexpr int ZERO_BLOCK_EXP = -126;
constexpr unsigned INF_BITS = 0x7F800000u;

// Exact float32 2^e (repro.core.bfp.pow2).
__device__ __forceinline__ float pow2i(int e) {
  if (e < -149) return 0.0f;
  if (e > 127) return __int_as_float(0x7F800000);
  if (e >= -126) return __int_as_float((e + 127) << 23);
  return __int_as_float(1 << (e + 149));
}

// The block's exponent from its amax bit pattern (amax > 0: a positive,
// non-NaN pattern), and the step's reciprocal where it is a normal float.
struct Block {
  int e;
  float step, inv;
  bool recip;
  __device__ __forceinline__ Block(unsigned amax, int bits) {
    e = (amax > 0u && amax <= INF_BITS) ? (int)((amax >> 23) & 0xFFu) - 127
                                        : ZERO_BLOCK_EXP;
    const int s = e - (bits - 2);
    step = pow2i(s);
    recip = s >= -126 && s <= 126;
    inv = recip ? pow2i(-s) : 0.0f;
  }
  // half-to-even; saturates to int32, NaN -> 0; then the clip to +-lim
  // and the int8 saturation
  __device__ __forceinline__ int quant(float v, int lim) const {
    const float q = recip ? __fmul_rn(v, inv) : __fdiv_rn(v, step);
    const int mi = min(max(__float2int_rn(q), -lim), lim);
    return min(max(mi, -128), 127);
  }
};

__global__ void __launch_bounds__(WARPS * 32)
bfp_quantize_kernel(const float* __restrict__ x, int8_t* __restrict__ m,
                    int* __restrict__ e_out, int K, int bk, int bits,
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
    const Block b(amax, bits);

    int8_t* mr = m + row * (long long)K;
    for (int k = k0 + lane; k < kend; k += 32)
      mr[k] = (int8_t)b.quant(xr[k], lim);
    if (lane == 0) e_out[row * n_t + t] = b.e;
  }
}

// Vector path: P lanes per block (a power of two >= bk / 16), of which
// the first bk / 16 hold 16 elements each; every lane of the warp takes
// part in each shuffle (the loop bound is warp-uniform).
__global__ void __launch_bounds__(WARPS * 32)
bfp_quantize_vec_kernel(const float* __restrict__ x, int8_t* __restrict__ m,
                        int* __restrict__ e_out, int K, int bk, int bits,
                        int P, long long n_blocks) {
  const int lane = threadIdx.x & 31;
  const int gl = lane & (P - 1);           // lane within the block's group
  const int per_warp = 32 / P;
  const int n_t = (K + bk - 1) / bk;
  const int lim = (1 << (bits - 1)) - 1;
  const long long warps = (long long)gridDim.x * WARPS;
  for (long long base = ((long long)blockIdx.x * WARPS + (threadIdx.x >> 5))
                        * per_warp;
       base < n_blocks; base += warps * per_warp) {
    const long long blk = base + lane / P;
    long long row = 0;
    int t = 0;
    bool live = false;
    if (blk < n_blocks) {
      row = blk / n_t;
      t = (int)(blk - row * n_t);
      live = t * bk + EPL * gl < min(t * bk + bk, K);
    }
    const long long at = row * (long long)K + t * bk + EPL * gl;
    float v[EPL];
    unsigned amax = 0u;
    if (live) {
      const float4* src = reinterpret_cast<const float4*>(x + at);
#pragma unroll
      for (int q = 0; q < EPL / 4; ++q) {
        const float4 f = __ldg(src + q);
        v[4 * q] = f.x;
        v[4 * q + 1] = f.y;
        v[4 * q + 2] = f.z;
        v[4 * q + 3] = f.w;
      }
#pragma unroll
      for (int i = 0; i < EPL; ++i)
        amax = max(amax, __float_as_uint(fabsf(v[i])));
    }
    for (int off = P >> 1; off; off >>= 1)  // within the aligned group
      amax = max(amax, __shfl_xor_sync(0xFFFFFFFFu, amax, off));
    if (!live) continue;
    const Block b(amax, bits);
    int o[EPL / 4];
#pragma unroll
    for (int q = 0; q < EPL / 4; ++q)
      o[q] = (int)(((unsigned)b.quant(v[4 * q], lim) & 0xFFu) |
                   (((unsigned)b.quant(v[4 * q + 1], lim) & 0xFFu) << 8) |
                   (((unsigned)b.quant(v[4 * q + 2], lim) & 0xFFu) << 16) |
                   ((unsigned)b.quant(v[4 * q + 3], lim) << 24));
    *reinterpret_cast<int4*>(m + at) = make_int4(o[0], o[1], o[2], o[3]);
    if (gl == 0) e_out[row * n_t + t] = b.e;
  }
}

constexpr long long MAX_GRID = 65535LL * 32;

int grid_for(long long warps) {
  const long long want = (warps + WARPS - 1) / WARPS;
  return (int)(want < MAX_GRID ? want : MAX_GRID);
}

}  // namespace

// 1 when bfp_quantize_launch takes the vector path for these operands,
// else 0: a pure function of shape and alignment.
extern "C" int bfp_quantize_vector_path(const void* x, const void* m, int K,
                                        int bk) {
  return K % EPL == 0 && bk % EPL == 0 && bk <= 32 * EPL &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(m) % 16 == 0;
}

extern "C" int bfp_quantize_launch(const void* x, void* m, void* e, int M,
                                   int K, int bk, int bits, void* stream) {
  if (M < 0 || K < 0 || bk < 1 || bits < 2 || bits > 24)
    return (int)cudaErrorInvalidValue;
  const long long n_blocks = (long long)M * ((K + bk - 1) / bk);
  if (n_blocks == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bfp_quantize_vector_path(x, m, K, bk)) {
    int P = 1;
    while (P < bk / EPL) P <<= 1;
    const int per_warp = 32 / P;
    bfp_quantize_vec_kernel<<<grid_for((n_blocks + per_warp - 1) / per_warp),
                              WARPS * 32, 0, s>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(m),
        static_cast<int*>(e), K, bk, bits, P, n_blocks);
  } else {
    bfp_quantize_kernel<<<grid_for(n_blocks), WARPS * 32, 0, s>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(m),
        static_cast<int*>(e), K, bk, bits, n_blocks);
  }
  return (int)cudaGetLastError();
}
