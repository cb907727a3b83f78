// Fused implicit-im2col BFP convolution for Hopper (sm_90a):
// NHWC x [B, H, W, C] f32 (*) HWIO w [KH, KW, C, OC] -> f32 [B, OH, OW, OC].
//
// Replaces the Pallas kernels of repro/kernels/bfp_conv.py:
// bfp_conv2d_pallas (weights quantized in the kernel) and
// bfp_conv2d_prequant_pallas (int8 mantissas + f32 steps), both built by
// _make_conv_kernel + _patch_rows and launched by _conv_call.  The
// weight mode is the W_PQ template flag of the shared tile kernel
// (bfp_tile.cuh, which states the arithmetic contract and the design).
//
// What bounds it on this card depends on the layer.  The early, wide-plane
// VGG16 convs (conv1_1 .. conv3_3 at batch 8) are bytes-bound: their f32
// activations in and out (up to 2 x 103 MB for conv1_2) take longer at
// 3.35 TB/s than their 0.7-15 G MACs take at the int8 tensor-core rate.
// The deep ones (conv4_x, conv5_x: 14x14 and 28x28 planes, 512 channels)
// are operations-bound.  This first kernel runs __dp4a on the CUDA cores
// and gathers every receptive-field element from global memory
// (L2-resident) twice per output-channel tile, so it sits far above
// either bound; the design answer is on-chip row windows feeding int8
// wgmma, with activations read once per tile, in a later PR.
//
// Padding is never materialized: an output pixel's receptive field
// starts at (oh*S - PT, ow*S - PL) and reads outside the input are zero
// (SAME or VALID geometry, any stride and kernel size, from the caller).
#include "bfp_tile.cuh"

extern "C" int bfp_conv_launch(const void* x, const void* w, const void* ws,
                               void* out, int B, int H, int W, int C, int KH,
                               int KW, int OC, int stride, int OH, int OW,
                               int pad_top, int pad_left, int bk, int l_i,
                               int l_w, int w_prequant, void* stream) {
  bfp::Params p = {};
  p.x = static_cast<const float*>(x);
  if (w_prequant) {
    p.wm = static_cast<const int8_t*>(w);
    p.ws = static_cast<const float*>(ws);
  } else {
    p.w = static_cast<const float*>(w);
  }
  p.out = static_cast<float*>(out);
  p.M = B * OH * OW;
  p.N = OC;
  p.K = KH * KW * C;
  p.bk = bk;
  p.l_i = l_i;
  p.l_w = l_w;
  p.H = H;
  p.W = W;
  p.C = C;
  p.KW = KW;
  p.S = stride;
  p.OH = OH;
  p.OW = OW;
  p.PT = pad_top;
  p.PL = pad_left;
  return bfp::launch<true>(p, w_prequant != 0,
                           static_cast<cudaStream_t>(stream));
}
