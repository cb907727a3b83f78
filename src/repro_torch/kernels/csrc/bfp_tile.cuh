// BFP tiled GEMM core shared by the matmul and conv kernels (sm_90a).
//
// Computes, for every output element (row r, column n),
//
//   out[r, n] = sum over K-tiles t = 0 .. n_k-1, in order, of
//               float(P_t[r, n]) * (sx_t[r] * sw_t[n])
//
// where P_t is the exact int32 dot of the tile's integer mantissas,
// x is block-formatted per (row, K-tile) and w per (column, K-tile)
// (Scheme.TILED with block_k = bk), each block taking
//   e = floor(log2 amax) from the f32 exponent field (-126 for a block
//       whose amax is not > 0, whose mantissas are then forced to 0),
//   step = 2^(e - (L-2)),  m = clamp(round_half_even(v / step), +-lim).
// That is the arithmetic of the Pallas kernels in repro/kernels
// (bfp_matmul.py _make_matmul_kernel, bfp_conv.py _make_conv_kernel),
// and it is bit-exact against them only if every float op rounds on its
// own: the build passes -fmad=false and the rescale uses __fmul_rn /
// __fadd_rn explicitly so no FFMA contraction can merge
// `acc + part * (sx * sw)`.
//
// Operand modes (template flags):
//  * W_PQ: w arrives as int8 mantissas [K, N] + f32 steps [n_k, N].
//  * X_PQ: x arrives in the activation wire format, int8 mantissas in
//    x's own layout + f32 steps per (row, K-tile): matmul [M, n_k]; conv
//    NHWC [B, H, W, C/bk] with bk | C, so K-tile t is exactly one
//    (di, dj, channel chunk) of one input pixel and its step is that
//    pixel's.  Outside the image the mantissas are 0 and the step 1.0,
//    as repro's ops._pad_act_nhwc pads them.  No amax pass for x.
//  * EPI, the requantize epilogue: instead of the f32 accumulator, store
//    it block-formatted per (row, out_block column chunk) with the same
//    block rules as the inputs: int8 mantissas [M, N] + f32 steps
//    [M, N/out_block] (repro's _requant_store and the conv out_q
//    branch).  Its thread block holds BN = 128 columns (VGG's block is
//    128), and a thread holds columns tx + 16j of its rows, so a chunk
//    (out_block | 128) is some of one thread's columns across a run of
//    the 16 lanes that share its rows: its amax is a max over those
//    columns, then over those lanes with warp shuffles.
//
// Design (one simple, correct kernel; speed is later work):
//  * grid: one block per BM output rows x BN output columns.  The
//    Pallas kernel's sequential K grid axis becomes the in-block loop
//    over K-tiles, so the f32 accumulation order is the reference's.
//  * per K-tile, pass 1 streams the tile once to take each row's (and,
//    for inline weights, each column's) amax; the max of |v| is taken
//    on the float bit patterns with atomicMax, which orders finite
//    floats and inf correctly and keeps a NaN (whose block the reference
//    zeroes).  Pass 2 streams the tile again in KC-wide chunks:
//    quantize (or, for wire operands, copy) into shared memory, then the
//    int dot (__dp4a on packed int8 when every operand fits int8;
//    WIDE: int32 MACs in 32-wide chunks).  Shared memory depends on the
//    tile, never on bk, and stays static (< 48 KB), so any bk the int32
//    overflow guard admits runs.
//  * the block rules (amax bits -> step, v -> mantissa) live in
//    bfp_block.cuh, shared with the int8 mma conv core (bfp_mma.cuh).
//  * CONV gathers receptive-field rows straight from the NHWC input in
//    global memory (HWIO-major k = (di*KW + dj)*C + c), zero in the
//    padding and beyond K: no padded copy, no whole planes in shared
//    memory (a 226x226x64 f32 plane is 13 MB).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bfp_block.cuh"

namespace bfp {

constexpr int BM = 64;         // output rows (pixels) per block
constexpr int NT = 256;        // threads per block (16 x 16)
constexpr int EPI_COLS = 128;  // epilogue column tile: out_block divides it

struct Params {
  const float* x;     // inline x: matmul [M, K]; conv NHWC [B, H, W, C]
  const int8_t* xm;   // wire x mantissas, same layout as x
  const float* xs;    // wire x steps: matmul [M, n_k]; conv [B, H, W, C / bk]
  const float* w;     // inline weights, GEMM view [K, N] row-major
  const int8_t* wm;   // prequant mantissas [K, N]
  const float* ws;    // prequant steps [n_k, N]
  float* out;         // f32 out [M, N]  (conv: [B, OH, OW, OC])
  int8_t* om;         // epilogue mantissas [M, N]
  float* os;          // epilogue steps [M, N / out_block]
  int M, N, K, bk, l_i, l_w, out_bits, out_block;
  int H, W, C, KW, S, OH, OW, PT, PL;   // conv geometry
};

// x[row, k] (f32 or wire mantissa) for a row < M and k < K.  CONV reads
// the receptive field, 0 outside the image.
template <bool CONV, typename T>
__device__ __forceinline__ T load_x(const T* x, const Params& p, int row,
                                    int k, long long base, int ih0, int iw0) {
  if (!CONV) return x[(size_t)row * p.K + k];
  const int kwc = p.KW * p.C;
  const int di = k / kwc;
  const int r = k - di * kwc;
  const int dj = r / p.C;
  const int c = r - dj * p.C;
  const int ih = ih0 + di;
  const int iw = iw0 + dj;
  if ((unsigned)ih >= (unsigned)p.H || (unsigned)iw >= (unsigned)p.W)
    return T(0);
  return x[base + ((long long)ih * p.W + iw) * p.C + c];
}

template <bool CONV, bool X_PQ, bool W_PQ, bool WIDE, bool EPI>
__global__ void __launch_bounds__(NT) bfp_tile_kernel(const Params p) {
  constexpr int BN = EPI ? EPI_COLS : 64;   // output columns per block
  constexpr int KC = WIDE ? 32 : 64;   // K elements staged per chunk
  constexpr int QC = KC / 4;           // 4-element quads per chunk row
  // Row stride (in ints) of the staged mantissas: odd, so the 16 column
  // threads of a half warp hit 16 different banks.
  constexpr int XS = WIDE ? KC + 1 : QC + 1;
  constexpr int WR = NT / BN;          // threads per column staging w
  constexpr int JN = BN / 16;          // output columns per thread
  __shared__ int s_xq[BM * XS];
  __shared__ int s_wq[BN * XS];
  __shared__ unsigned s_xamax[BM];
  __shared__ unsigned s_wamax[BN];
  __shared__ float s_xstep[BM], s_xinv[BM];
  __shared__ float s_wstep[BN], s_winv[BN];
  __shared__ int s_xmode[BM], s_wmode[BN];
  __shared__ long long s_base[BM];
  __shared__ int s_ih0[BM], s_iw0[BM];

  const int tid = threadIdx.x;
  const int tx = tid % 16;             // x quads: kq; MAC: column group
  const int ty = tid / 16;             // x quads/MAC: row group
  const int wc = tid % BN;             // w quads: column
  const int wk = tid / BN;             // w quads: first kq
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int lim_x = (1 << (p.l_i - 1)) - 1;
  const int lim_w = (1 << (p.l_w - 1)) - 1;
  const bool x_lane = 4 * tx < KC;     // stages x (WIDE chunks are 32)

  if (CONV && tid < BM) {
    const int row = row0 + tid;
    long long base = 0;
    int ih0 = 0, iw0 = 0;
    if (row < p.M) {
      const int ohw = p.OH * p.OW;
      const int b = row / ohw;
      const int r = row - b * ohw;
      const int oh = r / p.OW;
      const int ow = r - oh * p.OW;
      base = (long long)b * p.H * p.W * p.C;
      ih0 = oh * p.S - p.PT;
      iw0 = ow * p.S - p.PL;
    }
    s_base[tid] = base;
    s_ih0[tid] = ih0;
    s_iw0[tid] = iw0;
  }

  float acc[4][JN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < JN; ++j) acc[i][j] = 0.0f;

  const int n_k = (p.K + p.bk - 1) / p.bk;
  for (int t = 0; t < n_k; ++t) {
    const int k0 = t * p.bk;
    const int kend = min(k0 + p.bk, p.K);

    // ---- pass 1: block amax of the operands quantized here -------------
    if (!X_PQ && tid < BM) s_xamax[tid] = 0u;
    if (!W_PQ && tid < BN) s_wamax[tid] = 0u;
    __syncthreads();
    if (!X_PQ && x_lane) {
      unsigned xm[4] = {0u, 0u, 0u, 0u};
      for (int kc0 = k0; kc0 < kend; kc0 += KC) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int lr = ty + 16 * i;
          const int row = row0 + lr;
          if (row >= p.M) continue;
          long long base = 0;
          int ih0 = 0, iw0 = 0;
          if (CONV) { base = s_base[lr]; ih0 = s_ih0[lr]; iw0 = s_iw0[lr]; }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int k = kc0 + 4 * tx + u;
            if (k < kend)
              xm[i] = max(xm[i], abs_bits(load_x<CONV>(p.x, p, row, k, base,
                                                       ih0, iw0)));
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (xm[i]) atomicMax(&s_xamax[ty + 16 * i], xm[i]);
    }
    if (!W_PQ) {
      const int col = col0 + wc;
      unsigned wmax = 0u;
      if (col < p.N)
        for (int k = k0 + wk; k < kend; k += WR)
          wmax = max(wmax, abs_bits(p.w[(size_t)k * p.N + col]));
      if (wmax) atomicMax(&s_wamax[wc], wmax);
    }
    __syncthreads();
    if (tid < BM) {
      if (X_PQ) {
        const int row = row0 + tid;
        float st = 1.0f;               // rows beyond M: finite, inert
        if (row < p.M) {
          if (!CONV) {
            st = p.xs[(size_t)row * n_k + t];
          } else {
            const int kwc = p.KW * p.C;
            const int di = k0 / kwc;
            const int r = k0 - di * kwc;
            const int dj = r / p.C;
            const int cc = (r - dj * p.C) / p.bk;
            const int ih = s_ih0[tid] + di;
            const int iw = s_iw0[tid] + dj;
            if ((unsigned)ih < (unsigned)p.H && (unsigned)iw < (unsigned)p.W)
              st = p.xs[(s_base[tid] / p.C + (long long)ih * p.W + iw) *
                            (p.C / p.bk) + cc];
          }
        }
        s_xstep[tid] = st;
      } else {
        block_params(s_xamax[tid], p.l_i, &s_xstep[tid], &s_xinv[tid],
                     &s_xmode[tid]);
      }
    } else if (tid < BM + BN) {
      const int lc = tid - BM;
      const int col = col0 + lc;
      if (W_PQ) {
        s_wstep[lc] = col < p.N ? p.ws[(size_t)t * p.N + col] : 0.0f;
      } else {
        block_params(s_wamax[lc], p.l_w, &s_wstep[lc], &s_winv[lc],
                     &s_wmode[lc]);
      }
    }
    __syncthreads();

    // ---- pass 2: stage KC-wide chunks as mantissas, exact int dot -------
    int part[4][JN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < JN; ++j) part[i][j] = 0;

    for (int kc0 = k0; kc0 < kend; kc0 += KC) {
      const int nk = min(KC, kend - kc0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (!x_lane) break;
        const int lr = ty + 16 * i;
        const int row = row0 + lr;
        long long base = 0;
        int ih0 = 0, iw0 = 0;
        if (CONV) { base = s_base[lr]; ih0 = s_ih0[lr]; iw0 = s_iw0[lr]; }
        const float st = X_PQ ? 0.0f : s_xstep[lr];
        const float iv = X_PQ ? 0.0f : s_xinv[lr];
        const int md = X_PQ ? 0 : s_xmode[lr];
        int v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int k = kc0 + 4 * tx + u;
          v[u] = 0;
          if (row < p.M && k < kend)
            v[u] = X_PQ ? (int)load_x<CONV>(p.xm, p, row, k, base, ih0, iw0)
                        : quant(load_x<CONV>(p.x, p, row, k, base, ih0, iw0),
                                st, iv, md, lim_x);
        }
        if (WIDE) {
#pragma unroll
          for (int u = 0; u < 4; ++u) s_xq[lr * XS + 4 * tx + u] = v[u];
        } else {
          s_xq[lr * XS + tx] = pack4(v);
        }
      }
      {
        const int col = col0 + wc;
        const float st = W_PQ ? 0.0f : s_wstep[wc];
        const float iv = W_PQ ? 0.0f : s_winv[wc];
        const int md = W_PQ ? 0 : s_wmode[wc];
#pragma unroll
        for (int i = 0; i < QC / WR; ++i) {
          const int kq = wk + WR * i;
          int v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int k = kc0 + 4 * kq + u;
            v[u] = 0;
            if (col < p.N && k < kend) {
              const size_t off = (size_t)k * p.N + col;
              v[u] = W_PQ ? (int)p.wm[off] : quant(p.w[off], st, iv, md, lim_w);
            }
          }
          if (WIDE) {
#pragma unroll
            for (int u = 0; u < 4; ++u) s_wq[wc * XS + 4 * kq + u] = v[u];
          } else {
            s_wq[wc * XS + kq] = pack4(v);
          }
        }
      }
      __syncthreads();
      if (WIDE) {
        for (int kk = 0; kk < nk; ++kk) {
          int a[4], b[JN];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = s_xq[(ty + 16 * i) * XS + kk];
#pragma unroll
          for (int j = 0; j < JN; ++j) b[j] = s_wq[(tx + 16 * j) * XS + kk];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < JN; ++j) part[i][j] += a[i] * b[j];
        }
      } else {
        const int nq = (nk + 3) / 4;
        for (int kq = 0; kq < nq; ++kq) {
          int a[4], b[JN];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = s_xq[(ty + 16 * i) * XS + kq];
#pragma unroll
          for (int j = 0; j < JN; ++j) b[j] = s_wq[(tx + 16 * j) * XS + kq];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < JN; ++j)
              part[i][j] = __dp4a(a[i], b[j], part[i][j]);
        }
      }
      __syncthreads();
    }

    // ---- rescale and accumulate, in tile order -------------------------
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float sx = s_xstep[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        const float sxsw = __fmul_rn(sx, s_wstep[tx + 16 * j]);
        acc[i][j] = __fadd_rn(acc[i][j],
                              __fmul_rn(__int2float_rn(part[i][j]), sxsw));
      }
    }
  }

  if (!EPI) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty + 16 * i;
      if (row >= p.M) continue;
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        const int col = col0 + tx + 16 * j;
        if (col < p.N) p.out[(size_t)row * p.N + col] = acc[i][j];
      }
    }
    return;
  }

  // ---- requantize epilogue: one block per (row, out_block chunk) -------
  // Chunk of column tx + 16j: the j's with the same j / jspan, on the
  // lanes with the same tx / lspan (lanes differ from tx in its bits
  // only, since the 16 threads of a row group are one half warp).
  const int ob = p.out_block;
  const int jspan = ob > 16 ? ob / 16 : 1;
  const int lspan = ob < 16 ? ob : 16;
  const int lim_o = (1 << (p.out_bits - 1)) - 1;
  const int n_ob = p.N / ob;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    unsigned am[JN], cm[JN];
#pragma unroll
    for (int j = 0; j < JN; ++j) am[j] = abs_bits(acc[i][j]);
#pragma unroll
    for (int j = 0; j < JN; ++j) {
      const int j0 = j / jspan * jspan;
      cm[j] = 0u;
#pragma unroll
      for (int jj = 0; jj < JN; ++jj)
        if (jj >= j0 && jj < j0 + jspan) cm[j] = max(cm[j], am[jj]);
      for (int off = 1; off < lspan; off <<= 1)
        cm[j] = max(cm[j], __shfl_xor_sync(0xFFFFFFFFu, cm[j], off));
    }
    const int row = row0 + ty + 16 * i;
    if (row >= p.M) continue;
#pragma unroll
    for (int j = 0; j < JN; ++j) {
      const int lc = tx + 16 * j;
      const int col = col0 + lc;
      if (col >= p.N) continue;
      float st, iv;
      int md;
      block_params(cm[j], p.out_bits, &st, &iv, &md);
      p.om[(size_t)row * p.N + col] = (int8_t)quant(acc[i][j], st, iv, md,
                                                    lim_o);
      if (lc % ob == 0) p.os[(size_t)row * n_ob + col / ob] = st;
    }
  }
}

// EPI takes the 128-column tile, the f32 store the 64-column one.
template <bool CONV, bool X_PQ, bool W_PQ, bool WIDE>
inline int launch_cols(const Params& p, cudaStream_t stream) {
  if (p.out_bits) {
    const dim3 grid((p.M + BM - 1) / BM, (p.N + EPI_COLS - 1) / EPI_COLS);
    bfp_tile_kernel<CONV, X_PQ, W_PQ, WIDE, true><<<grid, NT, 0, stream>>>(p);
  } else {
    const dim3 grid((p.M + BM - 1) / BM, (p.N + 63) / 64);
    bfp_tile_kernel<CONV, X_PQ, W_PQ, WIDE, false><<<grid, NT, 0, stream>>>(p);
  }
  return (int)cudaGetLastError();
}

// WIDE (int32 mantissas, plain MACs) when an operand quantized in the
// kernel has L > 8; wire mantissas are int8 whatever their stated L.
template <bool CONV, bool X_PQ, bool W_PQ>
inline int launch_mode(const Params& p, cudaStream_t stream) {
  if constexpr (X_PQ && W_PQ) {
    return launch_cols<CONV, true, true, false>(p, stream);
  } else {
    const bool wide = (!X_PQ && p.l_i > 8) || (!W_PQ && p.l_w > 8);
    return wide ? launch_cols<CONV, X_PQ, W_PQ, true>(p, stream)
                : launch_cols<CONV, X_PQ, W_PQ, false>(p, stream);
  }
}

// Picks the instantiation from the operand modes; refuses an epilogue or
// wire-format x the kernel cannot honour (the wrappers check first).
template <bool CONV>
inline int launch(const Params& p, bool x_prequant, bool w_prequant,
                  cudaStream_t stream) {
  if (p.out_bits && (p.out_bits < 2 || p.out_bits > 8 || p.out_block < 1 ||
                     EPI_COLS % p.out_block || p.N % p.out_block))
    return (int)cudaErrorInvalidValue;
  if (x_prequant && (p.K % p.bk || (CONV && p.C % p.bk)))
    return (int)cudaErrorInvalidValue;
  if (x_prequant)
    return w_prequant ? launch_mode<CONV, true, true>(p, stream)
                      : launch_mode<CONV, true, false>(p, stream);
  return w_prequant ? launch_mode<CONV, false, true>(p, stream)
                    : launch_mode<CONV, false, false>(p, stream);
}

}  // namespace bfp
