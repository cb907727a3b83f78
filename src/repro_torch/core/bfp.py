"""Block floating point (BFP) formatting in PyTorch (counterpart of
``repro.core.bfp``).

A block of numbers shares one exponent (the max exponent in the block,
paper eq. 1); mantissas are stored as small signed integers.  Mantissa
width ``L`` INCLUDES the sign bit:

    eps   = max_i floor(log2 |x_i|)          (block exponent)
    delta = 2 ** (eps - (L - 2))             (quantization step)
    m_i   = clip(round(x_i / delta), -(2**(L-1)-1), 2**(L-1)-1)
    x'_i  = m_i * delta

Stochastic rounding takes an explicit uniform-noise tensor where the JAX
package takes a PRNG key: the two frameworks draw different numbers from
one seed, so callers (and the parity tests) hand the noise in.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Callable, Optional, Tuple

import torch

__all__ = [
    "Rounding",
    "Scheme",
    "BFPBlock",
    "pow2",
    "block_exponent",
    "quantize",
    "dequantize",
    "bfp_quantize_matrix",
    "average_bits_per_element",
    "num_block_exponents",
    "accumulator_bits",
    "max_safe_k",
]

#: Exponent used for an all-zero block (any finite value works; a very
#: negative one keeps dequantized zeros exact and the step harmless).
ZERO_BLOCK_EXP = -126

AmaxFn = Callable[[torch.Tensor], torch.Tensor]


def pow2(e) -> torch.Tensor:
    """EXACT float32 2^e for integer ``e``, built from the float bits.

    Exponent field for the normal range, a mantissa bit for the denormal
    range, +0 below 2^-149 and +inf above 2^127 — the same construction
    as ``repro.core.bfp.pow2`` (``exp2`` is an approximation and lands
    1 ulp off 2^e for some negative integers).
    """
    e = torch.as_tensor(e).to(torch.int32)
    normal = (e.clamp(-126, 127) + 127) << 23
    subnorm = torch.ones_like(e) << (e + 149).clamp(0, 22)
    bits = torch.where(e >= -126, normal, subnorm)
    bits = torch.where(e < -149, torch.zeros_like(bits), bits)
    bits = torch.where(e > 127, torch.full_like(bits, 0x7F800000), bits)
    return bits.view(torch.float32)


class Rounding(enum.Enum):
    """How out-shifted mantissa bits are handled (paper §3.1)."""

    ROUND = "round"
    TRUNCATE = "truncate"
    STOCHASTIC = "stochastic"


class Scheme(enum.Enum):
    """Matrix partition schemes for O = W[M,K] @ I[K,N] (paper eq. 2-5),
    plus TILED: one exponent per (row or column, K-tile)."""

    EQ2 = "eq2"
    EQ3 = "eq3"
    EQ4 = "eq4"
    EQ5 = "eq5"
    TILED = "tiled"


@dataclasses.dataclass(frozen=True)
class BFPBlock:
    """A block-formatted tensor: integer mantissas + per-block exponents.

    ``exponent`` is broadcastable against ``mantissa`` (keepdims layouts),
    or for TILED one entry per (row/col, K-tile).  ``bits`` includes the
    sign bit.
    """

    mantissa: torch.Tensor
    exponent: torch.Tensor
    bits: int

    @property
    def scale(self) -> torch.Tensor:
        """2^(eps - (L-2)) expanded to broadcast against ``mantissa``;
        a TILED exponent is repeated along its blocked axis."""
        e = self.exponent
        for ax, (se, sm) in enumerate(zip(e.shape, self.mantissa.shape)):
            if se not in (1, sm):
                e = torch.repeat_interleave(e, sm // se, dim=ax)
        return pow2(e - (self.bits - 2))

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return (self.mantissa.to(torch.float32) * self.scale).to(dtype)


def _mantissa_dtype(bits: int) -> torch.dtype:
    if bits <= 8:
        return torch.int8
    if bits <= 16:
        return torch.int16
    return torch.int32


def block_exponent(x: torch.Tensor, axes: Tuple[int, ...],
                   reduce_amax: Optional[AmaxFn] = None) -> torch.Tensor:
    """Per-block exponent max_i floor(log2 |x_i|) over ``axes`` (keepdims).

    frexp is exact for every finite float, subnormals included:
    x = f * 2^e with f in [0.5, 1)  =>  floor(log2|x|) = e - 1.
    ``reduce_amax`` maps the block maxima before the exponent is taken
    (``dist.sharding.group_amax``: the max over the rows other ranks
    hold).
    """
    amax = torch.amax(x.abs(), dim=axes, keepdim=True)
    if reduce_amax is not None:
        amax = reduce_amax(amax)
    _, e = torch.frexp(amax)
    return torch.where(amax > 0, e - 1,
                       torch.full_like(e, ZERO_BLOCK_EXP)).to(torch.int32)


def _apply_rounding(v: torch.Tensor, rounding: Rounding,
                    noise: Optional[torch.Tensor]) -> torch.Tensor:
    if rounding is Rounding.ROUND:
        return torch.round(v)      # round-half-to-even, like jnp.round
    if rounding is Rounding.TRUNCATE:
        return torch.floor(v)      # two's-complement right shift
    if rounding is Rounding.STOCHASTIC:
        if noise is None:
            raise ValueError("stochastic rounding requires uniform noise "
                             "in [0, 1) of the operand's shape")
        return torch.floor(v + noise.reshape(v.shape).to(v.dtype))
    raise ValueError(rounding)


def quantize(x: torch.Tensor, bits: int, axes: Tuple[int, ...],
             rounding: Rounding = Rounding.ROUND,
             noise: Optional[torch.Tensor] = None,
             reduce_amax: Optional[AmaxFn] = None) -> BFPBlock:
    """Block-format ``x``: one shared exponent per block spanning ``axes``
    (``reduce_amax``: see :func:`block_exponent`)."""
    if not 2 <= bits <= 24:
        raise ValueError(f"bits (incl. sign) must be in [2, 24], got {bits}")
    x = x.to(torch.float32)
    eps = block_exponent(x, axes, reduce_amax)
    step = pow2(eps - (bits - 2))
    lim = 2 ** (bits - 1) - 1
    m = _apply_rounding(x / step, rounding, noise)
    m = torch.clamp(m, -lim, lim).to(_mantissa_dtype(bits))
    return BFPBlock(mantissa=m, exponent=eps, bits=bits)


def dequantize(b: BFPBlock, dtype=torch.float32) -> torch.Tensor:
    return b.dequantize(dtype)


def _scheme_axes(scheme: Scheme, operand: str) -> Tuple[int, ...]:
    """Axes that SHARE an exponent for a 2-D GEMM operand (W [M,K],
    I [K,N])."""
    if scheme is Scheme.EQ2:
        return (0, 1)
    if scheme is Scheme.EQ3:
        return (1,) if operand == "w" else (0,)
    if scheme is Scheme.EQ4:
        return (1,) if operand == "w" else (0, 1)
    if scheme is Scheme.EQ5:
        return (0, 1) if operand == "w" else (0,)
    raise ValueError(f"use bfp_quantize_matrix(block_k=...) for {scheme}")


def bfp_quantize_matrix(x: torch.Tensor, bits: int, operand: str,
                        scheme: Scheme, block_k: Optional[int] = None,
                        rounding: Rounding = Rounding.ROUND,
                        noise: Optional[torch.Tensor] = None) -> BFPBlock:
    """Block-format one GEMM operand under a paper scheme or TILED.

    ``operand`` is "w" for [M,K] weights or "i" for [K,N] inputs.  For
    TILED, ``block_k`` must divide K and every (row/col, K-tile) pair
    has its own exponent.  ``noise`` (STOCHASTIC only) has ``x``'s shape.
    """
    if x.ndim != 2:
        raise ValueError(f"expected 2-D operand, got shape {tuple(x.shape)}")
    if operand not in ("w", "i"):
        raise ValueError(operand)
    if scheme is not Scheme.TILED:
        return quantize(x, bits, _scheme_axes(scheme, operand), rounding,
                        noise)
    k_axis = 1 if operand == "w" else 0
    k = x.shape[k_axis]
    bk = block_k or k
    if k % bk:
        raise ValueError(f"block_k={bk} must divide K={k}")
    if operand == "w":      # [M, K] -> [M, K//bk, bk], block over last axis
        xr = x.reshape(x.shape[0], k // bk, bk)
        b = quantize(xr, bits, (2,), rounding, noise)
        return BFPBlock(b.mantissa.reshape(x.shape),
                        b.exponent.reshape(x.shape[0], k // bk), bits)
    xr = x.reshape(k // bk, bk, x.shape[1])  # [K//bk, bk, N], middle axis
    b = quantize(xr, bits, (1,), rounding, noise)
    return BFPBlock(b.mantissa.reshape(x.shape),
                    b.exponent.reshape(k // bk, x.shape[1]), bits)


# ---------------------------------------------------------------------------
# Storage / datapath accounting (paper Table 1 and Fig. 2)
# ---------------------------------------------------------------------------

def num_block_exponents(scheme: Scheme, m: int, k: int, n: int,
                        block_k: Optional[int] = None) -> int:
    """NBE column of paper Table 1 (number of stored block exponents)."""
    if scheme is Scheme.EQ2:
        return 2
    if scheme is Scheme.EQ3:
        return m + n
    if scheme is Scheme.EQ4:
        return 1 + m
    if scheme is Scheme.EQ5:
        return 1 + n
    bk = block_k or k
    return (m + n) * -(-k // bk)   # partial K-tiles still carry an exponent


def average_bits_per_element(bits_mantissa_with_sign: int, exp_bits: int,
                             block_elems: int) -> float:
    """Average stored bits per number: L + L_e/n (paper §3.1)."""
    return bits_mantissa_with_sign + exp_bits / block_elems


def accumulator_bits(l_w: int, l_i: int, k: int) -> int:
    """Fixed-point accumulator width for a K-deep dot product (paper
    Fig. 2 / §3.4): L_W + L_I + ceil(log2 K)."""
    return l_w + l_i + int(math.ceil(math.log2(max(k, 2))))


def max_safe_k(l_w: int, l_i: int, acc_bits: int = 32) -> int:
    """Largest K for which int``acc_bits`` accumulation cannot overflow."""
    return 2 ** (acc_bits - l_w - l_i)
