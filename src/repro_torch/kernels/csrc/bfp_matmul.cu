// Fused BFP matmul for Hopper (sm_90a): x[M, K] f32 @ w[K, N] -> f32 [M, N].
//
// Replaces the Pallas kernels of repro/kernels/bfp_matmul.py:
// bfp_matmul_pallas (weights quantized in the kernel) and
// bfp_matmul_prequant_pallas (weights arrive as int8 mantissas + f32
// steps), both built by _make_matmul_kernel and launched by _matmul_call.
// The weight mode is the W_PQ template flag of the shared tile kernel
// (bfp_tile.cuh, which states the arithmetic contract and the design).
//
// What bounds it on this card: on the serving path (fc6/fc7/fc8 at a
// batch of a few images) the weight stream — fc6 alone is 102.8 M int8
// mantissas — is the only large operand, so the bound is bytes over the
// 3.35 TB/s of HBM.  This first kernel keeps 64-row tiles, so at batch 8
// most of each tile's __dp4a work is on zero rows and it runs well above
// that bound; a skinny-M tile and wgmma are later work.
#include "bfp_tile.cuh"

extern "C" int bfp_matmul_launch(const void* x, const void* w, const void* ws,
                                 void* out, int M, int N, int K, int bk,
                                 int l_i, int l_w, int w_prequant,
                                 void* stream) {
  bfp::Params p = {};
  p.x = static_cast<const float*>(x);
  if (w_prequant) {
    p.wm = static_cast<const int8_t*>(w);
    p.ws = static_cast<const float*>(ws);
  } else {
    p.w = static_cast<const float*>(w);
  }
  p.out = static_cast<float*>(out);
  p.M = M;
  p.N = N;
  p.K = K;
  p.bk = bk;
  p.l_i = l_i;
  p.l_w = l_w;
  return bfp::launch<false>(p, w_prequant != 0,
                            static_cast<cudaStream_t>(stream));
}
