// Fused BFP matmul for Hopper (sm_90a): x[M, K] @ w[K, N] -> f32 [M, N],
// or the requantized activation wire format (int8 [M, N] + f32 steps
// [M, N / out_block]) when out_bits > 0.
//
// Replaces the Pallas kernels of repro/kernels/bfp_matmul.py, all built
// by _make_matmul_kernel and launched by _matmul_call:
// bfp_matmul_pallas (x and w quantized in the kernel),
// bfp_matmul_prequant_pallas (w as int8 mantissas + f32 steps),
// bfp_matmul_xprequant_pallas (x as int8 mantissas + f32 steps, the
// previous layer's epilogue output) and bfp_matmul_xwprequant_pallas
// (both), each with the _requant_store epilogue.  The operand modes are
// the X_PQ / W_PQ template flags of the shared tile kernel (bfp_tile.cuh,
// which states the arithmetic contract and the design).
//
// Which calls still run here: every matmul that the int8 mma core can
// take (a power-of-two block from 32 to 512, L <= 8 where an operand is
// formatted, N % 4 == 0, an out_block that is a multiple of 4) runs on
// that core as a 1x1 conv, from bfp_conv.cu (kernels/bfp_matmul.py
// matmul_core).  This tile kernel keeps L > 8, other blocks, N % 4 != 0
// (reduced VGG16's fc8, N = 10) and an out_block of 1 or 2.
//
// What bounds it on this card: at a batch of a few images the weight
// stream is the only large operand, so the bound is bytes over the
// 3.35 TB/s of HBM.  This kernel keeps 64-row tiles, so at batch 8 most
// of each tile's __dp4a work is on zero rows and it runs well above that
// bound.
#include "bfp_tile.cuh"

extern "C" int bfp_matmul_launch(const void* x, const void* xs, const void* w,
                                 const void* ws, void* out, void* out_s, int M,
                                 int N, int K, int bk, int l_i, int l_w,
                                 int x_prequant, int w_prequant, int out_bits,
                                 int out_block, void* stream) {
  bfp::Params p = {};
  if (x_prequant) {
    p.xm = static_cast<const int8_t*>(x);
    p.xs = static_cast<const float*>(xs);
  } else {
    p.x = static_cast<const float*>(x);
  }
  if (w_prequant) {
    p.wm = static_cast<const int8_t*>(w);
    p.ws = static_cast<const float*>(ws);
  } else {
    p.w = static_cast<const float*>(w);
  }
  if (out_bits) {
    p.om = static_cast<int8_t*>(out);
    p.os = static_cast<float*>(out_s);
  } else {
    p.out = static_cast<float*>(out);
  }
  p.M = M;
  p.N = N;
  p.K = K;
  p.bk = bk;
  p.l_i = l_i;
  p.l_w = l_w;
  p.out_bits = out_bits;
  p.out_block = out_block;
  return bfp::launch<false>(p, x_prequant != 0, w_prequant != 0,
                            static_cast<cudaStream_t>(stream));
}
