"""Fused BFP matmul: CUDA kernel wrappers and their plain PyTorch versions.

Counterpart of ``repro.kernels.bfp_matmul`` (``bfp_matmul_pallas`` and
``bfp_matmul_prequant_pallas``).  Per K-tile of ``bk`` (the BFP block):
block-format x per row and w per column, exact integer tile dot, then
``acc = acc + part * (sx * sw)`` in f32, tiles in order 0 .. n_k-1.

A wrapper given CPU tensors runs the plain version; given CUDA tensors
it launches ``csrc/bfp_matmul.cu`` (built on first use) or raises —
there is no fallback from one to the other.  ``LAUNCHES`` counts kernel
launches per wrapper.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.bfp import ZERO_BLOCK_EXP, pow2
from repro_torch.kernels import _build

__all__ = ["bfp_matmul", "bfp_matmul_prequant", "bfp_matmul_plain",
           "bfp_matmul_prequant_plain", "check_overflow", "LAUNCHES"]

#: kernel launches per wrapper, incremented only where a kernel launches
LAUNCHES = {"bfp_matmul": 0, "bfp_matmul_prequant": 0}

#: f32 holds every integer of magnitude <= 2^24 exactly
_F32_EXACT_BOUND = 1 << 24

_INT_MAX = (1 << 31) - 1


def check_overflow(bk: int, l_sum: int) -> None:
    """Paper Fig. 2 accumulator sizing: int32 must hold ``bk`` products
    of L_I- and L_W-bit mantissas (``l_sum = L_I + L_W``)."""
    if bk < 1:
        raise ValueError(f"bk={bk} must be >= 1")
    if l_sum + math.ceil(math.log2(bk)) > 32:
        raise ValueError(f"bk={bk} overflows int32 for L_I+L_W={l_sum}")


def _floor_log2(amax: torch.Tensor) -> torch.Tensor:
    """floor(log2 x), x >= 0, from the float32 exponent field (a
    subnormal amax gives -127, as in the Pallas kernels)."""
    bits = amax.contiguous().view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 127
    return torch.where(amax > 0, e, torch.full_like(e, ZERO_BLOCK_EXP))


def block_format(tile: torch.Tensor, bits: int,
                 dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-format ``tile`` along ``dim`` -> (integer-valued f32
    mantissas, f32 steps with a keepdim 1 on ``dim``).  Blocks whose
    amax is not > 0 get mantissa 0."""
    amax = tile.abs().amax(dim=dim, keepdim=True)
    step = pow2(_floor_log2(amax) - (bits - 2))
    lim = float(2 ** (bits - 1) - 1)
    m = torch.clamp(torch.round(tile / step), -lim, lim)
    return torch.where(amax > 0, m, torch.zeros_like(m)), step


def _tile_dots(mx: torch.Tensor, mw: torch.Tensor, l_i: int, l_w: int,
               bk: int) -> torch.Tensor:
    """[n_k, B, bk] @ [n_k, bk, N] integer mantissas -> exact partials,
    rounded once to f32.  An f32 product is exact while every partial
    sum stays within 2^24 (and TF32 is off); beyond that f64 is exact
    for any tile the int32 overflow guard admits."""
    if bk * (2 ** (l_i - 1) - 1) * (2 ** (l_w - 1) - 1) <= _F32_EXACT_BOUND:
        return torch.matmul(mx, mw)
    return torch.matmul(mx.double(), mw.double()).float()


def tiled_plain(x: torch.Tensor, mw: torch.Tensor, sw: torch.Tensor,
                l_i: int, l_w: int, bk: int) -> torch.Tensor:
    """The shared plain datapath: x [B, n_k*bk] f32 (zero K-padding),
    weight mantissas mw [n_k, bk, N] and steps sw [n_k, 1, N]."""
    b = x.shape[0]
    n_k, _, n = mw.shape
    xt = x.reshape(b, n_k, bk).transpose(0, 1)            # [n_k, B, bk]
    mx, sx = block_format(xt, l_i, dim=2)                 # sx [n_k, B, 1]
    part = _tile_dots(mx, mw, l_i, l_w, bk)               # [n_k, B, N]
    out = torch.zeros((b, n), dtype=torch.float32, device=x.device)
    for t in range(n_k):
        out = out + part[t] * (sx[t] * sw[t])
    return out


def _pad_k(a: torch.Tensor, kp: int, dim: int) -> torch.Tensor:
    k = a.shape[dim]
    if k == kp:
        return a
    pad = [0, 0] * (a.ndim - 1 - dim) + [0, kp - k]
    return F.pad(a, pad)


def bfp_matmul_plain(x: torch.Tensor, w: torch.Tensor, l_i: int, l_w: int,
                     bk: int) -> torch.Tensor:
    """Plain version of the inline-weight kernel; K zero-pads to a ``bk``
    multiple (inert: no block amax changes, zero products)."""
    k, n = w.shape
    kp = -(-k // bk) * bk
    x = _pad_k(x.float(), kp, 1)
    wt = _pad_k(w.float(), kp, 0).reshape(kp // bk, bk, n)
    mw, sw = block_format(wt, l_w, dim=1)                 # sw [n_k, 1, N]
    return tiled_plain(x, mw, sw, l_i, l_w, bk)


def bfp_matmul_prequant_plain(x: torch.Tensor, wm: torch.Tensor,
                              ws: torch.Tensor, l_i: int, l_w: int,
                              bk: int) -> torch.Tensor:
    """Plain version of the prequant kernel: ``wm`` int8 [K, N], ``ws``
    f32 steps [K//bk, N], K a ``bk`` multiple."""
    k, n = wm.shape
    mw = wm.float().reshape(k // bk, bk, n)
    sw = ws.float().reshape(k // bk, 1, n)
    return tiled_plain(x.float(), mw, sw, l_i, min(l_w, 8), bk)


# ---------------------------------------------------------------------------
# CUDA launch
# ---------------------------------------------------------------------------

def _lib() -> ctypes.CDLL:
    lib = _build.load("bfp_matmul")
    fn = lib.bfp_matmul_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _check_cuda(*tensors: Optional[torch.Tensor]) -> torch.device:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"the kernels take CUDA tensors (CPU tensors run "
                         f"the plain version), got {dev}")
    for t in tensors:
        if t is not None and t.device != dev:
            raise ValueError(f"operands on different devices: {t.device} "
                             f"vs {dev}")
        if t is not None and not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
    return dev


def _launch(x, w, ws, l_i, l_w, bk, name) -> torch.Tensor:
    m, k = x.shape
    n = w.shape[1]
    if max(m, n, k) > _INT_MAX or -(-n // 64) > 65535:
        raise ValueError(f"shape ({m},{k})x({k},{n}) exceeds the kernel's "
                         f"int32 indexing / grid")
    dev = _check_cuda(x, w, ws)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().bfp_matmul_launch(
            x.data_ptr(), w.data_ptr(), None if ws is None else ws.data_ptr(),
            out.data_ptr(), m, n, k, bk, l_i, l_w, int(ws is not None),
            stream)
    if rc:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1
    return out


def bfp_matmul(x: torch.Tensor, w: torch.Tensor, *, l_i: int, l_w: int,
               bk: int) -> torch.Tensor:
    """x[B,K] @ w[K,N] f32 through the fused BFP datapath, both operands
    quantized per K-tile of ``bk`` (Scheme.TILED, block_k = bk)."""
    b, k = x.shape
    k2, n = w.shape
    if k != k2:
        raise ValueError(f"contraction mismatch {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    check_overflow(bk, l_i + l_w)
    if x.device.type == "cpu":
        return bfp_matmul_plain(x, w, l_i, l_w, bk)
    return _launch(x.float().contiguous(), w.float().contiguous(), None,
                   l_i, l_w, bk, "bfp_matmul")


def bfp_matmul_prequant(x: torch.Tensor, wm: torch.Tensor, ws: torch.Tensor,
                        *, l_i: int, l_w: int, bk: int) -> torch.Tensor:
    """x[B,K] @ prequant weight (int8 mantissa [K,N] + steps [K//bk,N]).
    ``l_w`` only sizes the overflow check."""
    b, k = x.shape
    k2, n = wm.shape
    if k != k2:
        raise ValueError(f"contraction mismatch {tuple(x.shape)} @ "
                         f"{tuple(wm.shape)}")
    check_overflow(bk, l_i + l_w)
    if k % bk or tuple(ws.shape) != (k // bk, n):
        raise ValueError(f"scale sidecar {tuple(ws.shape)} != "
                         f"{(k // bk, n)} for bk={bk}")
    if wm.dtype != torch.int8:
        raise ValueError(f"prequant kernel streams int8 mantissas, got "
                         f"{wm.dtype}")
    if x.device.type == "cpu":
        return bfp_matmul_prequant_plain(x, wm, ws, l_i, l_w, bk)
    return _launch(x.float().contiguous(), wm.contiguous(),
                   ws.float().contiguous(), l_i, l_w, bk,
                   "bfp_matmul_prequant")
