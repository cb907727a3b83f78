"""The default tile table (counterpart of ``repro.tune.tables``).

``aligned_tile`` is the one rule by which a wrapper pads a small or odd
problem dimension: to the nearest power of two, floored at 8 and capped.
``fallback_tiles`` and ``conv_row_tile`` are ``repro``'s defaults for a
GEMM's (bm, bn, bk) and a conv's output-row tile, equal to ``repro``'s
for every input; the autotuner starts its CPU walk from them.
``fallback_block_k`` is their K tile, which the GEMM wrappers take when
the policy names no block (``block_k=None``) and the active tune cache
has no entry.  On the card the row and column tiles are the kernels'
own (``kernels._mma.MMA_TILES``, chosen by ``_mma.mma_tile`` or a tuned
entry); only the K tile carries over from this table.
"""
from __future__ import annotations

from typing import Optional, Tuple

__all__ = ["MXU_DIM", "DEEP_K_BK", "aligned_tile", "overflow_cap",
           "fallback_tiles", "conv_row_tile", "fallback_block_k"]

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


def fallback_tiles(b: int, k: int, n: int, block_k: Optional[int],
                   l_sum: int = 16) -> Tuple[int, int, int]:
    """``repro``'s default (bm, bn, bk) for a (b, k) x (k, n) problem: bm
    and bn the aligned tiles of b and n, bk :func:`fallback_block_k`."""
    return aligned_tile(b), aligned_tile(n), fallback_block_k(k, block_k,
                                                              l_sum)


def conv_row_tile(oh: int, ow: int) -> int:
    """``repro``'s default output-row tile of its fused conv kernels:
    enough rows to make a >= 128-row M tile when OW is small, one row
    when OW alone is wide enough."""
    return max(1, min(oh, MXU_DIM // max(1, ow)))


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
