// Fused implicit-im2col BFP convolution for Hopper (sm_90a):
// NHWC x [B, H, W, C] (*) HWIO w [KH, KW, C, OC] -> f32 [B, OH, OW, OC],
// or the requantized activation wire format (int8 [B, OH, OW, OC] + f32
// steps [B, OH, OW, OC / out_block]) when out_bits > 0.
//
// Replaces the Pallas kernels of repro/kernels/bfp_conv.py, all built by
// _make_conv_kernel + _patch_rows and launched by _conv_call:
// bfp_conv2d_pallas (x and w quantized in the kernel),
// bfp_conv2d_prequant_pallas (w as int8 mantissas + f32 steps),
// bfp_conv2d_xprequant_pallas (x as int8 NHWC mantissas + f32 steps per
// (pixel, channel chunk), bk | C) and bfp_conv2d_xwprequant_pallas
// (both), each with the out_q epilogue.  The operand modes are the X_PQ /
// W_PQ template flags of the shared tile kernel (bfp_tile.cuh, which
// states the arithmetic contract and the design).
//
// What bounds it on this card depends on the layer.  The early, wide-plane
// VGG16 convs (conv1_1 .. conv3_3 at batch 8) are bytes-bound: their f32
// activations in and out (up to 2 x 103 MB for conv1_2) take longer at
// 3.35 TB/s than their 0.7-15 G MACs take at the int8 tensor-core rate;
// on the wire format (int8 in and out) those bytes shrink about 4x.
// The deep ones (conv4_x, conv5_x: 14x14 and 28x28 planes, 512 channels)
// are operations-bound.  This first kernel runs __dp4a on the CUDA cores
// and gathers every receptive-field element from global memory
// (L2-resident) once or twice per output-channel tile, so it sits far
// above either bound; the design answer is on-chip row windows feeding
// int8 wgmma, with activations read once per tile, in a later PR.
//
// Padding is never materialized: an output pixel's receptive field
// starts at (oh*S - PT, ow*S - PL) and reads outside the input are zero
// (SAME or VALID geometry, any stride and kernel size, from the caller).
#include "bfp_tile.cuh"

extern "C" int bfp_conv_launch(const void* x, const void* xs, const void* w,
                               const void* ws, void* out, void* out_s, int B,
                               int H, int W, int C, int KH, int KW, int OC,
                               int stride, int OH, int OW, int pad_top,
                               int pad_left, int bk, int l_i, int l_w,
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
  p.M = B * OH * OW;
  p.N = OC;
  p.K = KH * KW * C;
  p.bk = bk;
  p.l_i = l_i;
  p.l_w = l_w;
  p.out_bits = out_bits;
  p.out_block = out_block;
  p.H = H;
  p.W = W;
  p.C = C;
  p.KW = KW;
  p.S = stride;
  p.OH = OH;
  p.OW = OW;
  p.PT = pad_top;
  p.PL = pad_left;
  return bfp::launch<true>(p, x_prequant != 0, w_prequant != 0,
                           static_cast<cudaStream_t>(stream));
}
