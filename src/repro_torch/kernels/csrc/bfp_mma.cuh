// Weight-prequant BFP convolution on int8 tensor cores (sm_90a): the
// activation format pass and the mma.sync conv core.
//
// Replaces, for the weight-prequant conv modes, the Pallas kernel built
// by _make_conv_kernel + _patch_rows and launched by _conv_call
// (repro/kernels/bfp_conv.py:94, :219): bfp_conv2d_prequant_pallas (f32
// NHWC x, w as int8 mantissas + f32 steps) and
// bfp_conv2d_xwprequant_pallas with an f32 output (both operands in the
// wire format).  The inline-weight conv (bfp_conv2d_pallas) runs this
// core too, as a 1x1 conv over the patch matrix that bfp_pformat.cuh
// formats, and so do the matmuls with f32 x, as 1x1 convs over x viewed
// as [1, B, 1, K] (bfp_matmul_mma_launch, bfp_conv_patch_launch in
// bfp_conv.cu), and the x-prequant conv with float weights
// (bfp_conv2d_xprequant_pallas) after bfp_pformat.cuh's weight blocks
// alone.  The requantize epilogue of any of them is the format pass below
// run over the core's f32 output in out_block chunks (bfp_conv.cu
// oformat).  L > 8, a block that is not a power of two from 32 to 512,
// OC % 4 != 0, an out_block that is not a multiple of 4 and the
// wire-format matmuls stay on the tile kernel of bfp_tile.cuh; the
// wrappers (kernels/bfp_conv.py conv_core, kernels/bfp_matmul.py
// matmul_core) pick the core from shape and policy alone.
//
// Arithmetic (bit-identical to the tile kernel and to kernels/ref.py):
//   out[r, n] = sum over K-tiles t = 0 .. n_k-1, in order, of
//               float(P_t[r, n]) * (sx_t[r] * sw_t[n])
// P_t is the exact int32 dot of one K-tile's int8 mantissas (the guard
// L_I + L_W + ceil(log2 bk) <= 32 keeps every partial exact); each
// product and sum rounds on its own (__fmul_rn / __fadd_rn, -fmad=false).
//
// Why the x side can be formatted once.  With bk | C (which the prequant
// plan implies for odd kernels: K = kh*kw*C with K % bk == 0), K-tile
// t = (di*KW + dj)*(C/bk) + cc of output pixel (oh, ow) is exactly the
// channel chunk cc of input pixel (oh*S - PT + di, ow*S - PL + dj).  Its
// mantissas and step depend on that pixel chunk alone, so
//  * format pass: one warp per (pixel, chunk) reads its bk floats as
//    float4, takes the amax with warp shuffles on the bit patterns and
//    writes int8 mantissas [B, H, W, C] + f32 steps [B, H, W, C/bk],
//    with the block rules of bfp_block.cuh (the tile kernel's), not
//    prequant_act's frexp nor bfp_quantize's saturating rules;
//  * the core reads those as the wire format.  Outside the image it
//    reads mantissa 0 and step 1.0 (the tile kernel's X_PQ rule), where
//    the inline route formats a zero block (step 2^-(126+L-2)): each such
//    term is 0 * (sx * sw), +-0 for any finite sw and NaN for sw = inf or
//    NaN in both routes, so the sums agree bit for bit.
//
// What bounds it on this card.  ResNet-50 stage 4's 3x3 convs at batch 8
// (M, N, K = 392, 512, 4608) are 1.85 G int8 operations (0.94 us at
// 1,979 TOP/s) and 2.9 MB (0.87 us at 3.35 TB/s); VGG16's conv5_x (1568,
// 512, 4608) 7.4 G operations.  The tile kernel ran them at 0.2-0.4% of
// that: it re-gathered and re-quantized x for every 64-column tile and
// every receptive-field use (two integer divisions per element), took
// the dot with __dp4a on the CUDA cores, and launched 56 blocks for 132
// SMs.  This core:
//  * formats x once per pixel chunk (above), so a K-tile of a row is bk
//    contiguous bytes: one address computation per (row, K-tile), no
//    per-element division;
//  * takes the int dot on the tensor cores, mma.sync m16n8k32 s8.s8.s32:
//    per K-tile the int32 fragments start at 0 and are rescaled into the
//    f32 accumulator in tile order after bk/32 steps;
//  * stages the x rows (16-byte cp.async) and the w tile (4-byte
//    cp.async, so any N % 4 == 0 tiles) into a ring of NSTAGE
//    shared-memory stages: tile t+2 loads while tile t multiplies.  Rows
//    outside the image or beyond M are zero-filled by the copy itself
//    (src-size 0), and their step is copied from a 1.0 in global memory;
//  * w arrives [K, N] N-contiguous (the prequant sidecar), but mma wants
//    each column's K run contiguous: once a tile has landed, the block
//    transposes it in shared memory, 4x4 byte blocks with __byte_perm,
//    into a [n][k] buffer whose words are XOR-swizzled by n % 8, so each
//    B fragment register is one conflict-free 32-bit load.  No transposed
//    copy in device memory and no per-tensor cache;
//  * the row x column tile is a host choice among BM x BN = 64x128 (8
//    warps of 32x32, for large M: more work between barriers and half
//    the staged bytes per operation), 32x64, 32x32 and 16x32 (4 warps
//    of 16 rows): the first whose grid reaches 132 blocks, whose BN is
//    at most N (or 32) and whose shared memory fits (64x128: bk <= 256):
//      VGG16 conv4_x (6272 x 512): 64x128, 392 blocks; conv3_x (25088 x
//      256): 64x128, 784; conv5_x (1568 x 512): 32x64, 392; ResNet-50
//      stage-4 3x3 and 1x1 2048->512 (392 x 512): 32x32, 208; 1x1
//      512->2048 (392 x 2048): 32x64, 416; GoogLeNet 4c's 1x1 512->24
//      (1568 x 24): 16x32, 98 (no tile reaches 132).
//    A speed choice only: every tile computes the same sums in the same
//    order.  Staged x rows are padded by 16 bytes, which puts the 8 rows
//    of an A fragment load on 8 different bank quads.
// Split-K, wgmma and TMA are later work, once this core is measured.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bfp_block.cuh"

namespace bfp_mma {

using bfp::abs_bits;
using bfp::block_params;
using bfp::pack4;
using bfp::quant;

constexpr int NSTAGE = 3;      // cp.async ring depth
constexpr int PAD = 16;        // bytes added to every staged row
constexpr int MAX_BK = 512;    // 3 stages + the transposed tile < 227 KB
constexpr int FMT_NT = 256;    // format pass: 8 warps, one chunk each

// The step the core reads outside the image (cp.async source).
__device__ float kOneStep = 1.0f;

struct ConvParams {
  const int8_t* xm;   // wire x mantissas, NHWC [B, H, W, C]
  const float* xs;    // wire x steps [B, H, W, C / bk]
  const int8_t* wm;   // prequant mantissas, GEMM view [K, N]
  const float* ws;    // prequant steps [n_k, N]
  float* out;         // f32 [M, N] = NHWC [B, OH, OW, OC]
  int M, N, K, bk;
  int H, W, C, KW, S, OH, OW, PT, PL;
};

// ---- format pass: one warp per (pixel, channel chunk) -------------------
// Any run of n_chunks contiguous bk-float chunks (bk % 4 == 0, 16-byte
// aligned): the pixels' channel chunks of an NHWC x, or the out_block
// chunks of an f32 output's rows for the requantize epilogue.
__global__ void __launch_bounds__(FMT_NT)
xformat_kernel(const float* __restrict__ x, int8_t* __restrict__ xm,
               float* __restrict__ xs, long long n_chunks, int bk,
               int bits) {
  const long long chunk =
      ((long long)blockIdx.x * FMT_NT + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (chunk >= n_chunks) return;           // whole warps leave together
  const float4* src = reinterpret_cast<const float4*>(x + chunk * bk);
  const int n4 = bk >> 2;
  unsigned am = 0u;
  for (int i = lane; i < n4; i += 32) {
    const float4 v = __ldg(src + i);
    am = max(am, max(max(abs_bits(v.x), abs_bits(v.y)),
                     max(abs_bits(v.z), abs_bits(v.w))));
  }
#pragma unroll
  for (int off = 16; off; off >>= 1)
    am = max(am, __shfl_xor_sync(0xFFFFFFFFu, am, off));
  float step, inv;
  int mode;
  block_params(am, bits, &step, &inv, &mode);
  const int lim = (1 << (bits - 1)) - 1;
  int* dst = reinterpret_cast<int*>(xm + chunk * bk);
  for (int i = lane; i < n4; i += 32) {
    const float4 v = __ldg(src + i);
    const int q[4] = {quant(v.x, step, inv, mode, lim),
                      quant(v.y, step, inv, mode, lim),
                      quant(v.z, step, inv, mode, lim),
                      quant(v.w, step, inv, mode, lim)};
    dst[i] = pack4(q);
  }
  if (lane == 0) xs[chunk] = step;
}

inline int launch_xformat(const float* x, int8_t* xm, float* xs,
                          long long n_chunks, int bk, int bits,
                          cudaStream_t stream) {
  if (bk % 4 || bits < 2 || bits > 8 || n_chunks < 0)
    return (int)cudaErrorInvalidValue;
  constexpr int per_block = FMT_NT / 32;
  const long long blocks = (n_chunks + per_block - 1) / per_block;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  if (blocks)
    xformat_kernel<<<(unsigned)blocks, FMT_NT, 0, stream>>>(x, xm, xs,
                                                           n_chunks, bk,
                                                           bits);
  return (int)cudaGetLastError();
}

// ---- cp.async and mma.sync ------------------------------------------------
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Copy BYTES from global to shared, or zero-fill them when !valid.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(BYTES), "r"(n)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d += a (16x32 s8, row) * b (32x8 s8, col), exact int32.
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Transpose a 4x4 block of bytes: r[i] holds row i (4 columns, low byte
// first); c[j] gets column j (4 rows, low byte first).
__device__ __forceinline__ void transpose4x4(const unsigned (&r)[4],
                                             unsigned (&c)[4]) {
  const unsigned t0 = __byte_perm(r[0], r[1], 0x5140);  // a0 b0 a1 b1
  const unsigned t1 = __byte_perm(r[0], r[1], 0x7362);  // a2 b2 a3 b3
  const unsigned t2 = __byte_perm(r[2], r[3], 0x5140);  // c0 d0 c1 d1
  const unsigned t3 = __byte_perm(r[2], r[3], 0x7362);  // c2 d2 c3 d3
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

// Word k4 (k = 4*k4 .. 4*k4+3) of column n in the transposed w tile,
// whose rows are bk/4 = tw words: an XOR swizzle of the word index by
// n % 8 puts the 8 columns an m16n8 B fragment reads on 8 different bank
// quads, and the transpose's stores on at most 2-way conflicts.
__device__ __forceinline__ int wt_word(int n, int k4, int tw) {
  return n * tw + (k4 ^ (((n & 7) << 2) & (tw - 1)));
}

// Staged w row stride: one word past the tile width, so the transpose's
// 4-row reads (lanes over 8 k-blocks x 4 column words) hit 32 banks.
__host__ __device__ constexpr int w_row(int bn) { return bn + 4; }

__host__ __device__ constexpr int stage_bytes(int bm, int bn, int bk) {
  return bm * (bk + PAD) + bk * w_row(bn) + 4 * (bm + bn);
}

__host__ __device__ constexpr int smem_bytes(int bm, int bn, int bk) {
  return NSTAGE * stage_bytes(bm, bn, bk) + bn * bk;
}

// ---- the conv core --------------------------------------------------------
// BM x BN output tile per block, WARPS_M x WARPS_N warps, each warp
// WM = BM / WARPS_M rows (MT m16 tiles) x WN = BN / WARPS_N columns (NT8
// n8 tiles).
template <int BM, int BN, int WARPS_M, int WARPS_N>
__global__ void __launch_bounds__(32 * WARPS_M * WARPS_N)
    conv_mma_kernel(const ConvParams p) {
  constexpr int NT = 32 * WARPS_M * WARPS_N;   // threads
  constexpr int WM = BM / WARPS_M;     // rows per warp
  constexpr int MT = WM / 16;          // m16 tiles per warp
  constexpr int WN = BN / WARPS_N;     // columns per warp
  constexpr int NT8 = WN / 8;          // n8 tiles per warp
  constexpr int WROW = w_row(BN);      // staged w row stride (bytes)
  constexpr int NQ = BN / 4;           // 4-column words per staged w row
  static_assert(MT >= 1 && WM == 16 * MT && NT8 >= 1 && WN == 8 * NT8,
                "tile");
  static_assert(BM + BN <= NT, "step loaders");
  static_assert(NQ % 4 == 0, "transpose lanes");

  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long s_img[BM];      // b * H, or -1 for a row >= M
  __shared__ int s_ih0[BM], s_iw0[BM];

  const int bk = p.bk;
  const int xrow = bk + PAD;           // staged x row stride (bytes)
  const int x_bytes = BM * xrow;
  const int w_bytes = bk * WROW;
  const int sbytes = stage_bytes(BM, BN, bk);
  const int tw = bk >> 2;              // words per transposed w row
  unsigned* wt = reinterpret_cast<unsigned*>(smem + NSTAGE * sbytes);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int wr = warp / WARPS_N, wc = warp % WARPS_N;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const int cb = p.C / bk;             // channel chunks per pixel
  const int n_k = p.K / bk;

  if (tid < BM) {
    const int row = row0 + tid;
    long long img = -1;
    int ih0 = 0, iw0 = 0;
    if (row < p.M) {
      const int ohw = p.OH * p.OW;
      const int b = row / ohw;
      const int r = row - b * ohw;
      const int oh = r / p.OW;
      img = (long long)b * p.H;
      ih0 = oh * p.S - p.PT;
      iw0 = (r - oh * p.OW) * p.S - p.PL;
    }
    s_img[tid] = img;
    s_ih0[tid] = ih0;
    s_iw0[tid] = iw0;
  }
  __syncthreads();

  // Stage K-tile t into ring slot s: x rows [BM][bk+PAD], w [bk][BN+4],
  // x steps [BM], w steps [BN].  After the NSTAGE slots: the transposed
  // w tile [BN][bk].
  auto load_tile = [&](int t, int s) {
    unsigned char* st = smem + s * sbytes;
    unsigned char* sx_m = st;
    unsigned char* sw_m = st + x_bytes;
    float* sx_s = reinterpret_cast<float*>(st + x_bytes + w_bytes);
    float* sw_s = sx_s + BM;
    const int tap = t / cb;
    const int cc = t - tap * cb;
    const int di = tap / p.KW;
    const int dj = tap - di * p.KW;
    const int xch = bk >> 4;           // 16-byte chunks per x row
    for (int i = tid; i < BM * xch; i += NT) {
      const int r = i / xch;
      const int c = i - r * xch;
      const long long img = s_img[r];
      const int ih = s_ih0[r] + di, iw = s_iw0[r] + dj;
      const bool ok = img >= 0 && (unsigned)ih < (unsigned)p.H &&
                      (unsigned)iw < (unsigned)p.W;
      const int8_t* src =
          ok ? p.xm + ((img + ih) * p.W + iw) * p.C + cc * bk + c * 16
             : p.xm;
      cp_async<16>(sx_m + r * xrow + c * 16, src, ok);
    }
    if (tid < BM) {
      const long long img = s_img[tid];
      const int ih = s_ih0[tid] + di, iw = s_iw0[tid] + dj;
      const bool ok = img >= 0 && (unsigned)ih < (unsigned)p.H &&
                      (unsigned)iw < (unsigned)p.W;
      const float* src =
          ok ? p.xs + ((img + ih) * p.W + iw) * cb + cc : &kOneStep;
      cp_async<4>(sx_s + tid, src, true);
    } else if (tid >= NT - BN) {
      const int lc = tid - (NT - BN);
      const int col = col0 + lc;
      const bool ok = col < p.N;
      cp_async<4>(sw_s + lc, ok ? p.ws + (long long)t * p.N + col : p.ws,
                  ok);
    }
    // w rows as 4-byte copies (N % 4 == 0), columns beyond N zero
    const int8_t* wsrc = p.wm + (long long)t * bk * p.N + col0;
    for (int i = tid; i < bk * NQ; i += NT) {
      const int k = i / NQ;
      const int c = (i - k * NQ) * 4;
      const bool ok = col0 + c < p.N;
      cp_async<4>(sw_m + k * WROW + c,
                  ok ? wsrc + (long long)k * p.N + c : p.wm, ok);
    }
  };

  // The staged [k][n] w tile of ring slot s -> wt [n][k] (swizzled
  // words), 4x4 byte blocks: lanes take 8 k-blocks x 4 column words.
  auto transpose_w = [&](int s) {
    const unsigned char* sw_m = smem + s * sbytes + x_bytes;
    for (int b = tid; b < tw * NQ; b += NT) {
      const int kb = (b & 7) + ((b >> 3) / NQ) * 8;
      const int nq = (b >> 3) % NQ;
      unsigned r[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        r[i] = *reinterpret_cast<const unsigned*>(sw_m + (kb * 4 + i) * WROW +
                                                  nq * 4);
      transpose4x4(r, c);
#pragma unroll
      for (int j = 0; j < 4; ++j) wt[wt_word(nq * 4 + j, kb, tw)] = c[j];
    }
  };

  float acc[MT][NT8][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.0f;

#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < n_k) load_tile(s, s);
    cp_async_commit();
  }

  for (int t = 0; t < n_k; ++t) {
    cp_async_wait<NSTAGE - 2>();       // this thread's copies of tile t
    __syncthreads();                   // everyone's; slot of t-1 and wt
                                       // are free
    {
      const int tn = t + NSTAGE - 1;
      if (tn < n_k) load_tile(tn, tn % NSTAGE);
      cp_async_commit();
    }
    transpose_w(t % NSTAGE);
    __syncthreads();
    const unsigned char* st = smem + (t % NSTAGE) * sbytes;
    const unsigned char* xa = st + (wr * WM + g) * xrow + tq * 4;
    const float* sx_s = reinterpret_cast<const float*>(st + x_bytes +
                                                       w_bytes);
    const float* sw_s = sx_s + BM;

    int part[MT][NT8][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NT8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[m][j][i] = 0;
    for (int kk = 0; kk < bk; kk += 32) {
      unsigned a[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const unsigned char* xm = xa + m * 16 * xrow + kk;
        a[m][0] = *reinterpret_cast<const unsigned*>(xm);
        a[m][1] = *reinterpret_cast<const unsigned*>(xm + 8 * xrow);
        a[m][2] = *reinterpret_cast<const unsigned*>(xm + 16);
        a[m][3] = *reinterpret_cast<const unsigned*>(xm + 8 * xrow + 16);
      }
      const int k4 = (kk >> 2) + tq;
#pragma unroll
      for (int j = 0; j < NT8; ++j) {
        const int n = wc * WN + j * 8 + g;
        const unsigned b0 = wt[wt_word(n, k4, tw)];
        const unsigned b1 = wt[wt_word(n, k4 + 4, tw)];
#pragma unroll
        for (int m = 0; m < MT; ++m) mma_s8(part[m][j], a[m], b0, b1);
      }
    }

    // rescale and accumulate, in tile order
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int lr = wr * WM + m * 16 + g;
      const float sx0 = sx_s[lr], sx1 = sx_s[lr + 8];
#pragma unroll
      for (int j = 0; j < NT8; ++j) {
        const int lc = wc * WN + j * 8 + tq * 2;
        const float sw0 = sw_s[lc], sw1 = sw_s[lc + 1];
        float* c = acc[m][j];
        const int* q = part[m][j];
        c[0] = __fadd_rn(c[0], __fmul_rn(__int2float_rn(q[0]),
                                         __fmul_rn(sx0, sw0)));
        c[1] = __fadd_rn(c[1], __fmul_rn(__int2float_rn(q[1]),
                                         __fmul_rn(sx0, sw1)));
        c[2] = __fadd_rn(c[2], __fmul_rn(__int2float_rn(q[2]),
                                         __fmul_rn(sx1, sw0)));
        c[3] = __fadd_rn(c[3], __fmul_rn(__int2float_rn(q[3]),
                                         __fmul_rn(sx1, sw1)));
      }
    }
  }
  cp_async_wait<0>();                  // no copy outlives the block

#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int r0 = row0 + wr * WM + m * 16 + g;
#pragma unroll
    for (int j = 0; j < NT8; ++j) {
      const int col = col0 + wc * WN + j * 8 + tq * 2;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + (i >> 1) * 8;
        const int cn = col + (i & 1);
        if (row < p.M && cn < p.N)
          p.out[(long long)row * p.N + cn] = acc[m][j][i];
      }
    }
  }
}

template <int BM, int BN, int WARPS_M, int WARPS_N>
inline int launch_conv_tile(const ConvParams& p, cudaStream_t stream) {
  const int smem = smem_bytes(BM, BN, p.bk);
  auto* kernel = conv_mma_kernel<BM, BN, WARPS_M, WARPS_N>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((p.M + BM - 1) / BM, (p.N + BN - 1) / BN);
  kernel<<<grid, 32 * WARPS_M * WARPS_N, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// tile: 0 = 64x128 (8 warps of 32x32), 1 = 32x64, 2 = 32x32, 3 = 16x32
// (4 warps of 16 rows), rows x columns, the host's choice.  bk: a power
// of two from 32 to MAX_BK (the swizzle of the transposed w tile wraps
// within a row of bk/4 words); N % 4 == 0.
inline int launch_conv(const ConvParams& p, int tile, cudaStream_t stream) {
  if (p.bk < 32 || (p.bk & (p.bk - 1)) || p.bk > MAX_BK || p.C % p.bk ||
      p.K % p.bk || p.N % 4 || (p.N + 31) / 32 > 65535)
    return (int)cudaErrorInvalidValue;
  if (!p.M || !p.N) return 0;
  switch (tile) {
    case 0: return launch_conv_tile<64, 128, 2, 4>(p, stream);
    case 1: return launch_conv_tile<32, 64, 2, 2>(p, stream);
    case 2: return launch_conv_tile<32, 32, 2, 2>(p, stream);
    case 3: return launch_conv_tile<16, 32, 1, 4>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace bfp_mma
