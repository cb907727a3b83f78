"""Per-call FLOP attribution of a traced step (counterpart of
``repro.roofline.hlo_flops``).

The aggregate count says WHAT the step costs; this module says WHERE: it
buckets the counter's local matmul-family calls (``roofline.counter.Dot``:
``mm``, ``addmm``, ``bmm``, ``baddbmm``; an ``einsum`` arrives as the
``bmm`` it decomposes into) by shape signature, with ``repro``'s rows and
signature text (``lhs x rhs -> [out]``).  A call's FLOPs are
``FlopCounterMode``'s formula, 2 * prod(out) * K.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Tuple

__all__ = ["dot_flops", "top_dots", "summarize"]


def _sig(dot) -> str:
    def one(dt, shape):
        return f"{dt}[{','.join(str(d) for d in shape)}]"
    out = ",".join(str(d) for d in dot.out)
    return f"{one(*dot.lhs)} x {one(*dot.rhs)} -> [{out}]"


def dot_flops(dots: Iterable) -> List[Tuple[int, str, int]]:
    """[(flops, 'lhs_shape x rhs_shape -> out_shape', count)] per
    signature, largest first."""
    buckets: Dict[str, List[int]] = defaultdict(lambda: [0, 0])
    for d in dots:
        b = buckets[_sig(d)]
        b[0] += int(d.flops)
        b[1] += 1
    return sorted(((v[0], sig, v[1]) for sig, v in buckets.items()),
                  reverse=True)


def top_dots(dots: Iterable, n: int = 15) -> str:
    rows = dot_flops(dots)
    total = sum(r[0] for r in rows)
    lines = [f"total dot flops (per device): {total:.4g}"]
    for fl, sig, cnt in rows[:n]:
        lines.append(f"  {fl:12.4g} ({100*fl/max(total,1):5.1f}%) x{cnt:<4d} {sig}")
    return "\n".join(lines)


def summarize(dots: Iterable) -> Dict[str, float]:
    rows = dot_flops(dots)
    return {"dot_flops": float(sum(r[0] for r in rows)),
            "n_dot_signatures": len(rows)}
