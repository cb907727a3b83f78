"""Tile-size helpers of the kernel wrappers (counterpart of
``repro.tune.tables``; the fallback tile table and the tuner arrive with
the tune slice).

``aligned_tile`` is the one rule by which a wrapper pads a small or odd
problem dimension: to the nearest power of two, floored at 8 and capped.
"""
from __future__ import annotations

__all__ = ["MXU_DIM", "aligned_tile"]

#: the default cap of a tile dimension (``repro``'s MXU dimension)
MXU_DIM = 128


def _pow2_ge(d: int) -> int:
    """Smallest power of two >= d (d >= 1)."""
    return 1 << max(0, d - 1).bit_length()


def aligned_tile(d: int, cap: int = MXU_DIM) -> int:
    """Next power of two >= d, floored at 8 and capped at ``cap``."""
    return min(cap, max(8, _pow2_ge(d)))
