"""Tile tables of the kernel wrappers (counterpart of ``repro.tune.tables``;
the tuner and its cache arrive with the tune slice).

``aligned_tile`` is the one rule by which a wrapper pads a small or odd
problem dimension: to the nearest power of two, floored at 8 and capped.
``fallback_block_k`` is the K tile of ``repro``'s default tile table,
which the GEMM wrappers take when the policy names no block
(``block_k=None``).
"""
from __future__ import annotations

from typing import Optional

__all__ = ["MXU_DIM", "DEEP_K_BK", "aligned_tile", "overflow_cap",
           "fallback_block_k"]

#: the default cap of a tile dimension (``repro``'s MXU dimension)
MXU_DIM = 128

#: default K tile of a deep contraction (K >= this); shallow ones take
#: the aligned tile
DEEP_K_BK = 512


def _pow2_ge(d: int) -> int:
    """Smallest power of two >= d (d >= 1)."""
    return 1 << max(0, d - 1).bit_length()


def aligned_tile(d: int, cap: int = MXU_DIM) -> int:
    """Next power of two >= d, floored at 8 and capped at ``cap``."""
    return min(cap, max(8, _pow2_ge(d)))


def overflow_cap(l_sum: int) -> int:
    """Largest K tile whose int32 accumulation cannot overflow (paper
    Fig. 2 sizing): 2^(32 - (L_I + L_W))."""
    return 1 << max(0, 32 - l_sum)


def fallback_block_k(k: int, block_k: Optional[int], l_sum: int = 16) -> int:
    """The K tile of ``repro``'s ``fallback_tiles`` for a contraction of
    depth ``k``: the BFP block when given, else :data:`DEEP_K_BK` for a
    deep contraction and the aligned tile of K for a shallow one, capped
    by :func:`overflow_cap` so that an auto-picked block never overflows
    the int32 accumulator.  (Its row and column tiles have no use here:
    the CUDA kernels choose their own.)"""
    if block_k:
        return block_k
    return min(DEEP_K_BK if k >= DEEP_K_BK else aligned_tile(k),
               overflow_cap(l_sum))
