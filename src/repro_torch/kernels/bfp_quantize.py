"""Standalone BFP block formatting: the CUDA kernel's wrapper and its
plain PyTorch version.

Counterpart of ``repro.kernels.bfp_quantize`` (``bfp_quantize_pallas``):
f32 ``x [M, K]`` -> (int8 mantissas ``[M, K]``, int32 exponents
``[M, ceil(K / bk)]``), one BFP block per (row, ``bk``-wide K-tile) — the
paper's block-formatting stage, used to format a weight matrix once,
offline, into int8 + an exponent sidecar.  The block rules are the
Pallas kernel's: the exponent comes from the f32 exponent field of the
block's amax (-126 where the amax is not > 0, i.e. all zero or NaN; a
NaN block is not zeroed), the mantissa is ``round_half_even(x / step)``
clipped to ``+-(2^(bits-1) - 1)`` and then stored as int8 the way XLA
converts — saturated to [-128, 127], NaN to 0 — so ``bits > 8`` saturates.

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor
it launches ``csrc/bfp_quantize.cu`` (built on first use) or raises: one
launch per call, on the vector path (one read of x, 16-byte loads and
stores) when ``K % 16 == 0``, ``bk % 16 == 0``, ``bk <= 512`` and x
starts on 16 bytes, else on the scalar path (:func:`kernel_path`).  The
host side is kept lean for the many small weights of a model: no pad,
no slice, no ``torch.cuda.Stream`` object, a cached ctypes function.
``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.bfp import pow2
from repro_torch.kernels import _build, _mma
from repro_torch.kernels.bfp_matmul import _floor_log2

__all__ = ["bfp_quantize", "bfp_quantize_plain", "kernel_path", "LAUNCHES"]

#: kernel launches, incremented only where the kernel launches
LAUNCHES = {"bfp_quantize": 0}

_INT_MAX = (1 << 31) - 1


def _check(x: torch.Tensor, bits: int, bk: int) -> None:
    if x.ndim != 2:
        raise ValueError(f"expected x [M, K], got shape {tuple(x.shape)}")
    if not 2 <= bits <= 24:
        raise ValueError(f"bits (incl. sign) must be in [2, 24], got {bits}")
    if bk < 1:
        raise ValueError(f"bk={bk} must be >= 1")


def bfp_quantize_plain(x: torch.Tensor, bits: int,
                       bk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: K zero-pads to a ``bk`` multiple (zeros
    never change a block's amax) and is sliced back."""
    m_rows, k = x.shape
    n_t = -(-k // bk)
    xp = torch.nn.functional.pad(x.float(), (0, n_t * bk - k))
    tiles = xp.reshape(m_rows, n_t, bk)
    e = _floor_log2(tiles.abs().amax(dim=2, keepdim=True))  # NaN: -126
    lim = float(2 ** (bits - 1) - 1)
    q = torch.clamp(torch.round(tiles / pow2(e - (bits - 2))), -lim, lim)
    # XLA's f32 -> int8 conversion: saturating, NaN -> 0
    q = torch.where(torch.isnan(q), torch.zeros_like(q),
                    torch.clamp(q, -128.0, 127.0))
    m = q.to(torch.int8).reshape(m_rows, n_t * bk)[:, :k]
    return m.contiguous(), e.reshape(m_rows, n_t)


_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    """``csrc/bfp_quantize.cu``, its argument types set once."""
    global _LIB
    if _LIB is None:
        lib = _build.load("bfp_quantize")
        lib.bfp_quantize_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.bfp_quantize_launch.restype = ctypes.c_int
        lib.bfp_quantize_vector_path.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2)
        lib.bfp_quantize_vector_path.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def kernel_path(x: torch.Tensor, m: torch.Tensor, bk: int) -> str:
    """"vector" or "scalar": the path the kernel takes for CUDA x [M, K]
    and its int8 output m, as the launch decides it (shape and
    alignment)."""
    return ("vector" if _lib().bfp_quantize_vector_path(
        x.data_ptr(), m.data_ptr(), x.shape[1], bk) else "scalar")


def bfp_quantize(x: torch.Tensor, *, bits: int,
                 bk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [M, K] -> (int8 mantissas [M, K], int32 exponents
    [M, ceil(K / bk)]); the kernel masks the ragged last K-tile itself."""
    _check(x, bits, bk)
    if x.device.type == "cpu":
        return bfp_quantize_plain(x, bits, bk)
    if x.device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors (CPU tensors run "
                         f"the plain version), got {x.device}")
    m_rows, k = x.shape
    if max(m_rows, k) > _INT_MAX:
        raise ValueError(f"shape {tuple(x.shape)} exceeds the kernel's "
                         f"int32 indexing")
    if x.dtype is not torch.float32 or not x.is_contiguous():
        x = x.float().contiguous()
    dev = x.device
    m = torch.empty((m_rows, k), dtype=torch.int8, device=dev)
    e = torch.empty((m_rows, -(-k // bk)), dtype=torch.int32, device=dev)
    if m_rows and k:
        with _mma._on(dev):
            _mma._raise_on(_lib().bfp_quantize_launch(
                x.data_ptr(), m.data_ptr(), e.data_ptr(), m_rows, k, bk,
                bits, _mma._stream(dev)), "bfp_quantize")
        LAUNCHES["bfp_quantize"] += 1
    return m, e
