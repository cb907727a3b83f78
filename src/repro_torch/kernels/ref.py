"""Plain PyTorch oracles for the BFP kernels (counterpart of
``repro.kernels.ref``).

Semantics contract shared by kernel and oracle:

  * block exponent  e = floor(log2 max|x|) per (row, K-tile) of x and per
    (column, K-tile) of w  (Scheme.TILED with block_k = the kernel K tile)
  * mantissa        m = clip(round(x / 2^(e-(L-2))), -(2^(L-1)-1), ...)
  * product         exact integer dot of the mantissas per K-tile
  * rescale         partial * 2^(ex-(L_I-2)) * 2^(ew-(L_W-2)), f32
                    accumulation in tile order

These are deliberately independent re-implementations — they call
nothing in ``repro_torch.core`` nor the kernels' plain versions — so
kernel, plain version, oracle and core library triangulate.  They are
written for clarity on small tensors (tests), not for speed.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

__all__ = ["pow2", "quantize_tile", "bfp_quantize_ref", "bfp_conv2d_ref",
           "bfp_matmul_ref"]

_ZERO_BLOCK_EXP = -126


def pow2(e) -> torch.Tensor:
    """Exact float32 2^e for integer e, from the float bits (exponent
    field for normals, one mantissa bit for subnormals) — an independent
    copy of ``repro_torch.core.bfp.pow2``."""
    e = torch.as_tensor(e).to(torch.int32)
    normal = (e.clamp(-126, 127) + 127) << 23
    subnorm = torch.ones_like(e) << (e + 149).clamp(0, 22)
    bits = torch.where(e >= -126, normal, subnorm)
    bits = torch.where(e < -149, torch.zeros_like(bits), bits)
    bits = torch.where(e > 127, torch.full_like(bits, 0x7F800000), bits)
    return bits.view(torch.float32)


def _floor_log2(amax: torch.Tensor) -> torch.Tensor:
    """floor(log2 x) for x >= 0 from the exponent field (bit-exact)."""
    bits = amax.float().contiguous().view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 127
    return torch.where(amax > 0, e, torch.full_like(e, _ZERO_BLOCK_EXP))


def quantize_tile(x: torch.Tensor, bits: int,
                  dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-format along ``dim`` (the whole axis is one block) -> (m, e);
    m is int8 for bits <= 8, else int32, converted as XLA does (NaN to 0)."""
    amax = x.abs().amax(dim=dim, keepdim=True)
    e = _floor_log2(amax)
    step = pow2(e - (bits - 2))
    lim = float(2 ** (bits - 1) - 1)
    m = torch.clamp(torch.round(x.float() / step), -lim, lim)
    m = torch.where(torch.isnan(m), torch.zeros_like(m), m)
    return m.to(torch.int8 if bits <= 8 else torch.int32), e


def bfp_quantize_ref(x: torch.Tensor, bits: int,
                     block_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Oracle for the standalone quantize kernel: x [M, K] -> mantissa
    [M, K] (int8, or int32 for bits > 8, unsaturated), exponents
    [M, K // block_k] (int32); K must be a ``block_k`` multiple."""
    m_rows, k = x.shape
    if k % block_k:
        raise ValueError(f"block_k={block_k} must divide K={k}")
    m, e = quantize_tile(x.reshape(m_rows, k // block_k, block_k), bits,
                         dim=2)
    return m.reshape(m_rows, k), e.reshape(m_rows, k // block_k)


def bfp_conv2d_ref(x: torch.Tensor, w_hwio: torch.Tensor, l_i: int,
                   l_w: int, block_k: int, stride: int = 1,
                   padding: str = "SAME") -> torch.Tensor:
    """Oracle for the implicit-im2col conv kernels: the patch matrix built
    the slow, obvious way — a loop over (di, dj) offsets in HWIO-major K
    order, zero K-padding to a ``block_k`` multiple — then
    :func:`bfp_matmul_ref`."""
    b, h, w_in, c = x.shape
    kh, kw, _, oc = w_hwio.shape
    if padding == "SAME":
        oh, ow = -(-h // stride), -(-w_in // stride)
        ph = max((oh - 1) * stride + kh - h, 0)
        pw = max((ow - 1) * stride + kw - w_in, 0)
        pt, plf = ph // 2, pw // 2
        xp = F.pad(x, (0, 0, plf, pw - plf, pt, ph - pt))
    elif padding == "VALID":
        oh, ow = (h - kh) // stride + 1, (w_in - kw) // stride + 1
        xp = x
    else:
        raise ValueError(f"padding must be 'SAME' or 'VALID', got "
                         f"{padding!r}")
    slabs = []
    for di in range(kh):
        for dj in range(kw):
            slabs.append(xp[:, di:di + (oh - 1) * stride + 1:stride,
                            dj:dj + (ow - 1) * stride + 1:stride, :])
    patches = torch.stack(slabs, dim=3)                # [B,OH,OW,kh*kw,C]
    k = kh * kw * c
    kp = -(-k // block_k) * block_k
    cols = F.pad(patches.reshape(b * oh * ow, k), (0, kp - k))
    wmat = F.pad(w_hwio.reshape(k, oc), (0, 0, 0, kp - k))
    out = bfp_matmul_ref(cols, wmat, l_i, l_w, block_k)
    return out.reshape(b, oh, ow, oc)


def bfp_matmul_ref(x: torch.Tensor, w: torch.Tensor, l_i: int, l_w: int,
                   block_k: int) -> torch.Tensor:
    """Oracle for the fused BFP matmul: x [B, K] @ w [K, N] -> f32 [B, N].
    Per-(row, K-tile) blocks on x, per-(column, K-tile) blocks on w, exact
    integer tile dots (float64 holds every partial exactly), f32
    sequential accumulation over the K-tiles."""
    b, k = x.shape
    k2, n = w.shape
    if k != k2 or k % block_k:
        raise ValueError(f"shapes {tuple(x.shape)} @ {tuple(w.shape)} need "
                         f"equal K, a multiple of block_k={block_k}")
    out = torch.zeros((b, n), dtype=torch.float32, device=x.device)
    for ti in range(k // block_k):
        xs = x[:, ti * block_k:(ti + 1) * block_k]
        ws = w[ti * block_k:(ti + 1) * block_k, :]
        mx, ex = quantize_tile(xs, l_i, dim=1)           # [B,bk], [B,1]
        mw, ew = quantize_tile(ws, l_w, dim=0)           # [bk,N], [1,N]
        part = (mx.double() @ mw.double()).float()
        sx = pow2(ex - (l_i - 2))
        sw = pow2(ew - (l_w - 2))
        out = out + part * (sx * sw)
    return out
