// The patch format pass of the inline-weight BFP conv (sm_90a): both
// operands block-formatted once per call, so the int8 mma.sync core of
// bfp_mma.cuh can run the conv as a 1x1 conv over the patch matrix.
//
// Replaces, for the inline-weight conv with an f32 output
// (bfp_conv2d_pallas, repro/kernels/bfp_conv.py:278), the x_tile / w_tile
// block formatting inside _make_conv_kernel (bfp_conv.py:131-144): the
// Pallas kernel formats each patch K-tile and each weight K-tile in VMEM
// for every output tile; the tile kernel of bfp_tile.cuh did the same
// per 64 x 64 output tile (x re-gathered for every 64 columns, w for
// every 64 rows, integer divisions per element).  Here each block is
// formatted once:
//  * x side: bk / 16 lanes per (patch row r, K-tile t) block, so a warp
//    formats 32 / (bk / 16) blocks (4 at bk = 128).  Row r is output pixel
//    (b, oh, ow); element k = (di*KW + dj)*C + c of its HWIO-major patch
//    row is input pixel (oh*S - PT + di, ow*S - PL + dj), channel c, and
//    0 outside the image and for k >= K.  A lane takes 16 consecutive
//    elements: four 16-byte loads when 4 | C (each 4 are channels of one
//    pixel), else 16 scalar loads, with (di, dj, c) stepped from one
//    pair of divisions.  The lanes of a block take the amax on the bit
//    patterns with shuffles and apply the block rules of bfp_block.cuh
//    (the tile kernel's, not prequant_act's nor bfp_quantize's); each
//    lane writes its 16 int8 mantissas as one 16-byte store into
//    [rows, Kp], and the block's f32 step into [rows, n_k], Kp = n_k *
//    bk.  These are exactly the blocks the
//    tile kernel forms inline, image-border and K-tail zeros included: a
//    K-tile wholly outside the image is a zero block (step
//    2^-(126 + L-2), mantissas 0) in both.  bk | C is not needed: a tile
//    may span several (pixel, tap) slabs.
//  * w side, in the same launch (the first blocks of the grid, so that
//    their serial walks overlap the x blocks): the float GEMM-view weight
//    [K, N], zero-padded to Kp, per (K-tile, column), one thread per
//    column walking the tile's rows (consecutive threads read consecutive
//    columns): int8 [Kp, N] + f32 steps [n_k, N], the layout of the
//    prequant sidecar.
// The core then reads the patch matrix as a wire-format x of shape
// [1, rows, 1, Kp] (bk | Kp by construction): the sums are the tile
// kernel's, term for term, so the output is bit-identical.
// bfp_conv_patch_launch (bfp_conv.cu) issues this pass and the core from
// one host call: an inline conv costs the host one call, as on the tile
// kernel, and the card two launches.  With no patch rows the launch
// formats the weight alone: the x-prequant conv with float weights takes
// its w blocks from there (bfp_conv_mma_launch), once per call.
//
// What bounds it on this card: bytes, and per-warp instructions.  It
// reads x (each input pixel once from device memory while its kh rows of
// neighbours stay in L2) and writes one byte per patch element: VGG16
// conv1_2 at batch 8 reads 103 MB and writes 257 MB of mantissas + 8 MB
// of steps, 2M blocks of 128: per block the instructions have to stay
// few, so 16 elements go to a lane (4 blocks per warp), the index
// arithmetic is 32-bit, and the divisions by C, KW, OW, OH*OW and n_k are
// multiply-shifts (FastDiv), not divide instructions.  (One warp per
// block, with 4 elements a lane, ran at 6x this pass's byte bound on
// conv1_2.)
// Formatting inside the core (staging f32 patch tiles in shared memory)
// would save the patch round trip; that is later work.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bfp_block.cuh"

namespace bfp_pformat {

using bfp::abs_bits;
using bfp::block_params;
using bfp::pack4;
using bfp::quant;

constexpr int NT = 256;        // threads per block: 8 x-warps, or 256 columns
constexpr int EPL = 16;        // patch elements per lane

// n / d for 0 <= n < 2^31, d >= 1, without a divide instruction
// (Granlund and Montgomery's round-up method, as CUTLASS's FastDivmod):
// s = ceil(log2 d), m = floor(2^32 (2^s - d) / d) + 1, and
// n / d = (umulhi(n, m) + n) >> s (umulhi(n, m) <= n, so the sum fits).
struct FastDiv {
  unsigned m, s;
  __device__ __forceinline__ int operator()(int n) const {
    return (int)((__umulhi((unsigned)n, m) + (unsigned)n) >> s);
  }
};

inline FastDiv make_div(int d) {
  unsigned s = 0;
  while ((1ull << s) < (unsigned long long)d) ++s;
  const unsigned long long m =
      ((1ull << 32) * ((1ull << s) - (unsigned long long)d)) / d + 1;
  return FastDiv{(unsigned)m, s};
}

struct Params {
  const float* x;     // f32 NHWC [B, H, W, C]
  const float* w;     // f32 GEMM-view weight [K, N]
  int8_t* xm;         // patch mantissas [rows, Kp] of this chunk
  float* xs;          // patch steps [rows, n_k]
  int8_t* wm;         // weight mantissas [Kp, N]
  float* ws;          // weight steps [n_k, N]
  int row0;           // first patch row (output pixel) of the chunk
  int rows;           // patch rows in the chunk
  int with_w;         // format the weight too (the first chunk only)
  int K, N, bk, n_k, l_i, l_w;
  int H, W, C, KW, S, OHW, OW, PT, PL;
  FastDiv div_nk, div_ohw, div_ow, div_c, div_kw;
};

// The EPL elements k0 .. k0+EPL-1 of a patch row whose receptive field
// starts at input pixel (ih0, iw0) of image img: 0 outside the image and
// for k >= K.  (di, dj, c) of k0 come from two FastDivs, the rest by
// stepping.  VEC (4 | C, 4 | k0): each 4 are channels of one pixel, one
// 16-byte load.
template <bool VEC>
__device__ __forceinline__ void load_run(const Params& p, const float* img,
                                         int ih0, int iw0, int k0,
                                         float (&v)[EPL]) {
  const int tap = p.div_c(k0);
  int c = k0 - tap * p.C;
  int di = p.div_kw(tap);
  int dj = tap - di * p.KW;
  constexpr int STEP = VEC ? 4 : 1;
#pragma unroll
  for (int e = 0; e < EPL; e += STEP) {
    const int ih = ih0 + di, iw = iw0 + dj;
    const bool in = k0 + e < p.K && (unsigned)ih < (unsigned)p.H &&
                    (unsigned)iw < (unsigned)p.W;
    const float* src = img + (ih * p.W + iw) * p.C + c;
    if (VEC) {
      const float4 q = in ? __ldg(reinterpret_cast<const float4*>(src))
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      v[e] = q.x;
      v[e + 1] = q.y;
      v[e + 2] = q.z;
      v[e + 3] = q.w;
    } else {
      v[e] = in ? __ldg(src) : 0.0f;
    }
    c += STEP;
    if (c == p.C) {
      c = 0;
      if (++dj == p.KW) {
        dj = 0;
        ++di;
      }
    }
  }
}

// One patch block per G = bk / EPL lanes, 32 / G blocks per warp: lane
// gl of a group holds elements 16*gl .. 16*gl+15 of its block.
template <bool VEC>
__device__ __forceinline__ void format_x(const Params& p, int warp,
                                         int lane) {
  const int g = p.bk / EPL;             // lanes per block: 2 .. 32
  const int blk = warp * (32 / g) + lane / g;
  const int gl = lane % g;
  const bool live = blk < p.rows * p.n_k;
  float v[EPL];
  unsigned am = 0u;
  if (live) {
    const int r = p.div_nk(blk);
    const int t = blk - r * p.n_k;
    const int row = p.row0 + r;
    const int b = p.div_ohw(row);
    const int rr = row - b * p.OHW;
    const int oh = p.div_ow(rr);
    const float* img = p.x + (long long)b * p.H * p.W * p.C;
    load_run<VEC>(p, img, oh * p.S - p.PT, (rr - oh * p.OW) * p.S - p.PL,
                  t * p.bk + EPL * gl, v);
#pragma unroll
    for (int e = 0; e < EPL; ++e) am = max(am, abs_bits(v[e]));
  }
  for (int off = g >> 1; off; off >>= 1)  // within the aligned group
    am = max(am, __shfl_xor_sync(0xFFFFFFFFu, am, off));
  if (!live) return;
  float step, inv;
  int mode;
  block_params(am, p.l_i, &step, &inv, &mode);
  const int lim = (1 << (p.l_i - 1)) - 1;
  int o[EPL / 4];
#pragma unroll
  for (int q = 0; q < EPL / 4; ++q) {
    const int m[4] = {quant(v[4 * q], step, inv, mode, lim),
                      quant(v[4 * q + 1], step, inv, mode, lim),
                      quant(v[4 * q + 2], step, inv, mode, lim),
                      quant(v[4 * q + 3], step, inv, mode, lim)};
    o[q] = pack4(m);
  }
  *reinterpret_cast<int4*>(p.xm + (long long)blk * p.bk + EPL * gl) =
      make_int4(o[0], o[1], o[2], o[3]);
  if (gl == 0) p.xs[blk] = step;
}

__device__ __forceinline__ void format_w(const Params& p, int i) {
  const int t = i / p.N;
  const int n = i - t * p.N;
  const int k0 = t * p.bk;
  const int kend = min(k0 + p.bk, p.K);
  const float* src = p.w + n;
  unsigned am = 0u;
#pragma unroll 4
  for (int k = k0; k < kend; ++k)
    am = max(am, abs_bits(__ldg(src + (long long)k * p.N)));
  float step, inv;
  int mode;
  block_params(am, p.l_w, &step, &inv, &mode);
  const int lim = (1 << (p.l_w - 1)) - 1;
#pragma unroll 4
  for (int k = k0; k < k0 + p.bk; ++k)
    p.wm[(long long)k * p.N + n] =
        (int8_t)(k < kend ? quant(__ldg(src + (long long)k * p.N), step, inv,
                                  mode, lim)
                          : 0);
  p.ws[(long long)t * p.N + n] = step;
}

// Blocks [0, w_blocks) format weight columns, one thread each; the rest
// format patch blocks, 8 warps each and 32 / (bk / 16) blocks per warp
// (block index r * n_k + t, so a patch block's mantissas start at its
// index * bk and its step is xs[index]).
template <bool VEC>
__global__ void __launch_bounds__(NT)
    pformat_kernel(const Params p, int w_blocks) {
  if ((int)blockIdx.x < w_blocks) {
    const int i = blockIdx.x * NT + threadIdx.x;
    if (i < p.n_k * p.N) format_w(p, i);
    return;
  }
  const int warp =
      (int)((((long long)blockIdx.x - w_blocks) * NT + threadIdx.x) >> 5);
  format_x<VEC>(p, warp, threadIdx.x & 31);
}

// bk: a power of two from 32 to 512; L <= 8 (int8 mantissas).  The
// caller keeps rows * Kp, Kp * N, the rows of the whole patch matrix and
// x's elements below 2^31 (the indices are 32-bit).
inline int launch(Params p, cudaStream_t stream) {
  if (p.bk < 2 * EPL || p.bk > 32 * EPL || (p.bk & (p.bk - 1)) ||
      p.l_i < 2 || p.l_i > 8 || p.l_w < 2 || p.l_w > 8 || p.rows < 0 ||
      p.K < 1 || p.N < 0 || p.C < 1 || p.KW < 1 || p.OW < 1 || p.OHW < 1)
    return (int)cudaErrorInvalidValue;
  p.n_k = (p.K + p.bk - 1) / p.bk;
  if ((long long)p.rows * p.n_k * p.bk > 0x7FFFFFFFLL ||
      (long long)p.n_k * p.bk * p.N > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  p.div_nk = make_div(p.n_k);
  p.div_ohw = make_div(p.OHW);
  p.div_ow = make_div(p.OW);
  p.div_c = make_div(p.C);
  p.div_kw = make_div(p.KW);
  const int per_warp = 32 / (p.bk / EPL);
  const long long warps = ((long long)p.rows * p.n_k + per_warp - 1) /
                          per_warp;
  const int x_blocks = (int)((warps + NT / 32 - 1) / (NT / 32));
  const int w_blocks = p.with_w ? (p.n_k * p.N + NT - 1) / NT : 0;
  if (!x_blocks && !w_blocks) return 0;
  const dim3 grid(x_blocks + w_blocks);
  if (p.C % 4 == 0)
    pformat_kernel<true><<<grid, NT, 0, stream>>>(p, w_blocks);
  else
    pformat_kernel<false><<<grid, NT, 0, stream>>>(p, w_blocks);
  return (int)cudaGetLastError();
}

}  // namespace bfp_pformat
