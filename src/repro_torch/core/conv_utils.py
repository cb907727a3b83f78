"""Convolution-as-GEMM geometry and layout (counterpart of
``repro.core.conv_utils``).

One K-order everywhere, **HWIO-major**: the patch-matrix column index is
``k = (di*kw + dj)*C + c``, so the weight view is
``w_hwio.reshape(kh*kw*C, out_ch)`` with no transpose, and the CUDA conv
kernel's on-chip gather, the materialized :func:`im2col` and the
``prequant_conv_leaf`` sidecars all agree on the TILED blocks.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

__all__ = ["conv_geometry", "im2col", "conv_weight_matrix"]


def conv_geometry(h: int, w: int, kh: int, kw: int, stride: int,
                  padding: str) -> Tuple[int, int, Tuple[int, int],
                                         Tuple[int, int]]:
    """XLA's SAME/VALID geometry: (oh, ow, (pad_top, pad_bot),
    (pad_left, pad_right))."""
    if padding == "SAME":
        oh, ow = -(-h // stride), -(-w // stride)
        ph = max((oh - 1) * stride + kh - h, 0)
        pw = max((ow - 1) * stride + kw - w, 0)
        return oh, ow, (ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2)
    if padding == "VALID":
        if h < kh or w < kw:
            raise ValueError(f"VALID conv: input {h}x{w} smaller than "
                             f"kernel {kh}x{kw}")
        return (h - kh) // stride + 1, (w - kw) // stride + 1, (0, 0), (0, 0)
    raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")


def im2col(x: torch.Tensor, kh: int, kw: int, stride: int, padding: str,
           value: float = 0.0) -> Tuple[torch.Tensor, Tuple[int, int, int]]:
    """NHWC -> patch matrix [B*OH*OW, kh*kw*C] in HWIO-major K-order;
    ``value`` fills the padding."""
    b, h, w, c = x.shape
    oh, ow, (pt, pb), (pl, pr) = conv_geometry(h, w, kh, kw, stride,
                                               padding)
    xp = F.pad(x, (0, 0, pl, pr, pt, pb), value=value)
    slabs = [xp[:, di:di + (oh - 1) * stride + 1:stride,
                dj:dj + (ow - 1) * stride + 1:stride, :]
             for di in range(kh) for dj in range(kw)]
    patches = torch.stack(slabs, dim=3)            # [B, OH, OW, kh*kw, C]
    return patches.reshape(b * oh * ow, kh * kw * c), (b, oh, ow)


def conv_weight_matrix(w_hwio: torch.Tensor) -> torch.Tensor:
    """HWIO kernel -> its GEMM view [kh*kw*C, out_ch] (HWIO-major K)."""
    kh, kw, c, n = w_hwio.shape
    return w_hwio.reshape(kh * kw * c, n)
