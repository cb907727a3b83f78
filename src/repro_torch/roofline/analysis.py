"""Roofline terms of one traced step on an NVIDIA H100 (counterpart of
``repro.roofline.analysis``).

    compute term    = flops      / peak_flops
    memory term     = bytes      / hbm_bw
    collective term = wire bytes / (ici_bw * n_links)

``flops`` and ``bytes`` are PER DEVICE, from ``roofline.counter`` (the
port's stand-in for the compiled program's cost analysis).  Collective
bytes are the result-shape bytes of every functional collective the
trace issued, summed per kind, then weighted by the ring algorithm's
traffic factor (all-gather and reduce-scatter move (n-1)/n of the full
payload per device, all-reduce twice that, all-to-all (n-1)/n).

``HW()`` holds the H100 SXM5's data-sheet figures: 989.4e12 dense bf16
FLOP/s, 3.35e12 B/s of HBM3, and NVLink 4 at 25e9 B/s per link per
direction, of which a device has :data:`N_LINKS` (18).  The link term
models one NVLink domain (a node of 8 GPUs); a mesh beyond one node
crosses InfiniBand, which this term does not model.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Tuple

__all__ = ["HW", "N_LINKS", "KINDS", "collective_kind", "collective_bytes",
           "roofline_terms", "RooflineReport"]

#: NVLink 4 links per H100 SXM5.
N_LINKS = 18


@dataclasses.dataclass(frozen=True)
class HW:
    """Per-device constants (H100 SXM5 data sheet, dense)."""
    peak_flops: float = 989.4e12     # bf16 FLOP/s
    hbm_bw: float = 3.35e12          # B/s
    ici_bw: float = 25e9             # B/s per NVLink link, per direction
    chips: int = 1


#: The collective kinds of the report, in ``repro``'s names.
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

# functional-collective op name fragments -> kind (first match wins)
_OP_KINDS = (("all_gather", "all-gather"), ("all_reduce", "all-reduce"),
             ("reduce_scatter", "reduce-scatter"),
             ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
             ("permute", "collective-permute"),
             ("broadcast", "collective-permute"))


def collective_kind(op_name: str) -> Optional[str]:
    """The kind of a ``_c10d_functional`` (or ``c10d``) op, by name; None
    for what moves no data (``wait_tensor``, ``_wrap_tensor_autograd``)
    and for ops outside those namespaces."""
    if "c10d" not in op_name:
        return None
    for frag, kind in _OP_KINDS:
        if frag in op_name:
            return kind
    return None


def collective_bytes(records: Iterable[Tuple[str, int]]) -> Dict[str, int]:
    """Sum result bytes per collective kind.

    ``records``: ``(op name, result bytes)`` pairs, as the counter
    records every functional collective of a trace (a coalesced op's
    bytes are those of all its results).  Ops of no kind are skipped.
    """
    out: Dict[str, int] = {}
    for name, nbytes in records:
        kind = collective_kind(name)
        if kind is not None:
            out[kind] = out.get(kind, 0) + int(nbytes)
    return out


def _wire_bytes(coll: Dict[str, int], n_chips: int) -> float:
    """Per-device wire traffic with ring-algorithm factors."""
    f = (n_chips - 1) / max(n_chips, 1)
    total = 0.0
    total += coll.get("all-gather", 0) * f
    total += coll.get("reduce-scatter", 0) * f
    total += coll.get("all-reduce", 0) * 2 * f
    total += coll.get("all-to-all", 0) * f
    total += coll.get("collective-permute", 0)
    return total


def roofline_terms(cost: Dict[str, float], coll: Dict[str, int],
                   hw: HW = HW(), n_links: int = N_LINKS
                   ) -> Dict[str, float]:
    """The three per-step roofline terms, in seconds.

    cost: ``{"flops", "bytes accessed"}`` PER DEVICE (the counter's local
    shards).  n_links: links per device that carry the collectives.
    """
    flops = float(cost.get("flops", 0.0))
    bytes_hbm = float(cost.get("bytes accessed", 0.0))
    t_compute = flops / hw.peak_flops
    t_memory = bytes_hbm / hw.hbm_bw
    t_coll = _wire_bytes(coll, hw.chips) / (hw.ici_bw * n_links)
    dominant = max((("compute", t_compute), ("memory", t_memory),
                    ("collective", t_coll)), key=lambda kv: kv[1])[0]
    return {"t_compute": t_compute, "t_memory": t_memory,
            "t_collective": t_coll, "dominant": dominant,
            "hlo_flops": flops, "hlo_bytes": bytes_hbm,
            "collective_wire_bytes": _wire_bytes(coll, hw.chips)}


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    terms: Dict[str, float]
    collectives: Dict[str, int]
    memory_per_device: Optional[float]
    model_flops: float               # 6*N*D (dense) or 6*N_active*D
    useful_ratio: float              # model_flops / (chips * flops)

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)
