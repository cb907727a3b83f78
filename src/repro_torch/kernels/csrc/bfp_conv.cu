// BFP convolution for Hopper (sm_90a).  Two cores share this library:
// the weight-prequant modes run on the int8 mma.sync core of bfp_mma.cuh
// after its activation format pass (bfp_conv_xformat_launch,
// bfp_conv_mma_launch; that header's note states its design); so does
// the inline-weight conv, after the patch format pass of bfp_pformat.cuh
// (bfp_conv_patch_launch: the pass, then the core as a 1x1 conv over the
// patch matrix), and the x-prequant conv with float weights, after that
// pass's weight blocks alone (bfp_conv_mma_launch with w).  The matmuls
// run on the same core as 1x1 convs over x viewed as [1, B, 1, K]:
// bfp_matmul_mma_launch below for f32 x and prequant weights,
// bfp_conv_patch_launch for f32 x and float weights, and
// bfp_conv_mma_launch with w for wire-format x and float weights, and
// with neither pass for both operands on the wire.  With out_bits, each
// of these routes ends in the requantize epilogue as a third pass: the
// activation format pass over the core's f32 output in out_block chunks
// (oformat below).  L > 8, blocks that are not a power of two from 32 to
// 512, OC % 4 != 0 and an out_block that is not a multiple of 4 run on
// the tile kernel, as follows.
//
// Fused implicit-im2col BFP convolution on the tile kernel:
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
// are operations-bound.  The tile kernel runs __dp4a on the CUDA cores
// and gathers every receptive-field element from global memory
// (L2-resident) once or twice per output-channel tile, so it sits far
// above either bound.  The convs with L <= 8 and power-of-two blocks left
// it for the mma core (x formatted once per pixel chunk or per patch
// block, w once per call, int8 tensor cores, the epilogue as a pass over
// the f32 output).
//
// Padding is never materialized: an output pixel's receptive field
// starts at (oh*S - PT, ow*S - PL) and reads outside the input are zero
// (SAME or VALID geometry, any stride and kernel size, from the caller).
#include "bfp_mma.cuh"
#include "bfp_pformat.cuh"
#include "bfp_tile.cuh"

// Block-format an f32 NHWC activation per (pixel, bk channel chunk):
// int8 mantissas [B, H, W, C] + f32 steps [B, H, W, C / bk]; n_chunks =
// B*H*W*C / bk.
extern "C" int bfp_conv_xformat_launch(const void* x, void* xm, void* xs,
                                       long long n_chunks, int bk, int bits,
                                       void* stream) {
  return bfp_mma::launch_xformat(static_cast<const float*>(x),
                                 static_cast<int8_t*>(xm),
                                 static_cast<float*>(xs), n_chunks, bk, bits,
                                 static_cast<cudaStream_t>(stream));
}

namespace {

bfp_pformat::Params pformat_params(const void* x, const void* w, void* xm,
                                   void* xs, void* wm, void* ws, int row0,
                                   int rows, int with_w, int H, int W, int C,
                                   int KH, int KW, int OC, int stride,
                                   int OH, int OW, int pad_top, int pad_left,
                                   int bk, int l_i, int l_w) {
  bfp_pformat::Params p = {};
  p.x = static_cast<const float*>(x);
  p.w = static_cast<const float*>(w);
  p.xm = static_cast<int8_t*>(xm);
  p.xs = static_cast<float*>(xs);
  p.wm = static_cast<int8_t*>(wm);
  p.ws = static_cast<float*>(ws);
  p.row0 = row0;
  p.rows = rows;
  p.with_w = with_w;
  p.K = KH * KW * C;
  p.N = OC;
  p.bk = bk;
  p.l_i = l_i;
  p.l_w = l_w;
  p.H = H;
  p.W = W;
  p.C = C;
  p.KW = KW;
  p.S = stride;
  p.OHW = OH * OW;
  p.OW = OW;
  p.PT = pad_top;
  p.PL = pad_left;
  return p;
}

// The requantize epilogue on the mma core's routes: the activation format
// pass over the core's f32 output [rows, N], one block per (row, out_block
// chunk).  A row-major row's out_block chunks are contiguous, so these are
// the tile kernel's epilogue blocks (bfp_tile.cuh EPI), with its block
// rules; the f32 output is the tile kernel's accumulator bit for bit.  No
// pass when out_bits == 0.
int oformat(const float* out, void* om, void* os, long long rows, int N,
            int out_bits, int out_block, cudaStream_t s) {
  if (!out_bits) return 0;
  if (out_block < 4 || N % out_block) return (int)cudaErrorInvalidValue;
  return bfp_mma::launch_xformat(out, static_cast<int8_t*>(om),
                                 static_cast<float*>(os),
                                 rows * (N / out_block), out_block, out_bits,
                                 s);
}

}  // namespace

// The patch format pass alone: patch rows [row0, row0 + rows) of the f32
// NHWC x -> int8 [rows, Kp] + f32 steps [rows, n_k]; with with_w, the f32
// GEMM-view weight [K, OC] -> int8 [Kp, OC] + f32 steps [n_k, OC].  With
// rows = 0 and with_w, the weight blocks alone (x, xm and xs unread).
extern "C" int bfp_conv_pformat_launch(const void* x, const void* w,
                                       void* xm, void* xs, void* wm,
                                       void* ws, int row0, int rows,
                                       int with_w, int H, int W, int C,
                                       int KH, int KW, int OC, int stride,
                                       int OH, int OW, int pad_top,
                                       int pad_left, int bk, int l_i,
                                       int l_w, void* stream) {
  return bfp_pformat::launch(
      pformat_params(x, w, xm, xs, wm, ws, row0, rows, with_w, H, W, C, KH,
                     KW, OC, stride, OH, OW, pad_top, pad_left, bk, l_i,
                     l_w),
      static_cast<cudaStream_t>(stream));
}

// The inline conv on the mma core, for patch rows [row0, row0 + rows):
// the patch format pass into xm/xs (and wm/ws when with_w), then the core
// as a 1x1 conv over [1, rows, 1, Kp] into rows [row0, row0 + rows) of
// the f32 out [M, OC]; with out_bits, then the output format pass over
// those rows into om [M, OC] and os [M, OC / out_block].  Two or three
// launches, one host call.
extern "C" int bfp_conv_patch_launch(const void* x, const void* w, void* xm,
                                     void* xs, void* wm, void* ws, void* out,
                                     void* om, void* os, int row0, int rows,
                                     int with_w, int H, int W, int C, int KH,
                                     int KW, int OC, int stride, int OH,
                                     int OW, int pad_top, int pad_left,
                                     int bk, int l_i, int l_w, int out_bits,
                                     int out_block, int tile, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = bfp_pformat::launch(
      pformat_params(x, w, xm, xs, wm, ws, row0, rows, with_w, H, W, C, KH,
                     KW, OC, stride, OH, OW, pad_top, pad_left, bk, l_i,
                     l_w),
      s);
  if (rc) return rc;
  const int kp = (KH * KW * C + bk - 1) / bk * bk;
  bfp_mma::ConvParams p = {};
  p.xm = static_cast<const int8_t*>(xm);
  p.xs = static_cast<const float*>(xs);
  p.wm = static_cast<const int8_t*>(wm);
  p.ws = static_cast<const float*>(ws);
  p.out = static_cast<float*>(out) + (long long)row0 * OC;
  p.M = rows;
  p.N = OC;
  p.K = kp;
  p.bk = bk;
  p.H = rows;
  p.W = 1;
  p.C = kp;
  p.KW = 1;
  p.S = 1;
  p.OH = rows;
  p.OW = 1;
  const int rc2 = bfp_mma::launch_conv(p, tile, s);
  if (rc2 || !out_bits) return rc2;
  const long long r0 = row0;
  return oformat(p.out, static_cast<int8_t*>(om) + r0 * OC,
                 static_cast<float*>(os) + r0 * (OC / out_block), rows, OC,
                 out_bits, out_block, s);
}

// The weight-prequant matmul with an f32 output on the mma core: f32 x
// [M, K] @ int8 wm [K, N] (steps ws [K / bk, N]) -> f32 out [M, N].
// Replaces, for that case, bfp_matmul_prequant_pallas
// (repro/kernels/bfp_matmul.py:388).  A matmul is the 1x1, stride-1,
// unpadded conv over x viewed as NHWC [1, M, 1, K]: a (row, K-tile) block
// is a (pixel, channel chunk) block, and the sidecar [K / bk, N] is the
// conv's.  So the activation format pass writes xm [M, K] int8 + xs
// [M, K / bk] f32 into the caller's workspace and the core runs that
// conv: two launches, one host call (the ResNet and GoogLeNet forwards
// are host-bound, and a GEMM costs them one ctypes call, as on the tile
// kernel).  No new core and no new tile: the bits are the prequant conv's.
//
// What bounds it on this card: at the served batch of a few images the
// weight stream is the only large operand (fc6: 102.8 MB of int8
// mantissas, 3.2 MB of steps, 0.8 MB of x), so the bound is bytes over
// the 3.35 TB/s of HBM, ~0.032 ms for fc6.  The tile kernel gave every
// 64-row tile eight zero rows per real one and re-formatted x for every
// column tile.  Here x is formatted once (a few hundred KB), each weight
// byte is read once, by the one 16-row tile that covers the batch, and
// the int dot runs on the tensor cores.  What the route does not do:
// with N / 32 blocks (128 for fc6, 32 for fc8), each walking its K-tiles
// through a 3-stage ring of 4 KB weight tiles, too few bytes are in
// flight for HBM's full rate; a skinny-M tile or an order-keeping split-K
// would add them.
// With out_bits, the output format pass follows the core (om [M, N], os
// [M, N / out_block]): the requantize epilogue of bfp_matmul_prequant, in
// the same host call.
extern "C" int bfp_matmul_mma_launch(const void* x, const void* wm,
                                     const void* ws, void* xm, void* xs,
                                     void* out, void* om, void* os, int M,
                                     int N, int K, int bk, int l_i,
                                     int out_bits, int out_block, int tile,
                                     void* stream) {
  if (bk < 1 || K % bk) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = bfp_mma::launch_xformat(
      static_cast<const float*>(x), static_cast<int8_t*>(xm),
      static_cast<float*>(xs), (long long)M * (K / bk), bk, l_i, s);
  if (rc) return rc;
  bfp_mma::ConvParams p = {};
  p.xm = static_cast<const int8_t*>(xm);
  p.xs = static_cast<const float*>(xs);
  p.wm = static_cast<const int8_t*>(wm);
  p.ws = static_cast<const float*>(ws);
  p.out = static_cast<float*>(out);
  p.M = M;
  p.N = N;
  p.K = K;
  p.bk = bk;
  p.H = M;
  p.W = 1;
  p.C = K;
  p.KW = 1;
  p.S = 1;
  p.OH = M;
  p.OW = 1;
  const int rc2 = bfp_mma::launch_conv(p, tile, s);
  if (rc2) return rc2;
  return oformat(p.out, om, os, M, N, out_bits, out_block, s);
}

// The conv on the int8 mma core with x in the wire format (the format
// pass's output or a previous layer's epilogue) -> f32 out [M, OC].  The
// passes around the core, each in this one host call when asked for:
//  * x (f32 NHWC, else null): the activation format pass writes it into
//    xm/xs first (L = l_i): the prequant conv;
//  * w (f32 GEMM-view weight [K, OC], else null): the patch format pass's
//    weight blocks alone write it into wm/ws first (L = l_w), once per
//    call: the x-prequant conv with float weights, and the x-prequant
//    matmul as the 1x1 conv over [1, B, 1, K].  bk | C, so Kp = K and
//    these are the tile kernel's inline w blocks of that mode, which the
//    tile kernel formed again for every 64-row output tile;
//  * out_bits: the output format pass then writes om [M, OC] and os
//    [M, OC / out_block] from out: the requantize epilogue.
extern "C" int bfp_conv_mma_launch(const void* x, const void* w, void* xm,
                                   void* xs, void* wm, void* ws, void* out,
                                   void* om, void* os, int B, int H, int W,
                                   int C, int KH, int KW, int OC, int stride,
                                   int OH, int OW, int pad_top, int pad_left,
                                   int bk, int l_i, int l_w, int out_bits,
                                   int out_block, int tile, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x) {
    if (bk < 1 || C % bk) return (int)cudaErrorInvalidValue;
    const int rc = bfp_mma::launch_xformat(
        static_cast<const float*>(x), static_cast<int8_t*>(xm),
        static_cast<float*>(xs), (long long)B * H * W * (C / bk), bk, l_i,
        s);
    if (rc) return rc;
  }
  if (w) {
    const int rc = bfp_pformat::launch(
        pformat_params(nullptr, w, nullptr, nullptr, wm, ws, 0, 0, 1, H, W,
                       C, KH, KW, OC, stride, OH, OW, pad_top, pad_left, bk,
                       l_w, l_w),
        s);
    if (rc) return rc;
  }
  bfp_mma::ConvParams p = {};
  p.xm = static_cast<const int8_t*>(xm);
  p.xs = static_cast<const float*>(xs);
  p.wm = static_cast<const int8_t*>(wm);
  p.ws = static_cast<const float*>(ws);
  p.out = static_cast<float*>(out);
  p.M = B * OH * OW;
  p.N = OC;
  p.K = KH * KW * C;
  p.bk = bk;
  p.H = H;
  p.W = W;
  p.C = C;
  p.KW = KW;
  p.S = stride;
  p.OH = OH;
  p.OW = OW;
  p.PT = pad_top;
  p.PL = pad_left;
  const int rc = bfp_mma::launch_conv(p, tile, s);
  if (rc) return rc;
  return oformat(p.out, om, os, p.M, OC, out_bits, out_block, s);
}

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
