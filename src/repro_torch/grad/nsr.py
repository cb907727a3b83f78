"""Measured gradient NSR against the analytic bound, per backward GEMM
(counterpart of ``repro.grad.nsr``).

The backward tap events carry EXACTLY the operands the backward GEMM
executed (already transposed, already tile-fitted policy), so the same
:func:`repro_torch.core.nsr.gemm_nsr_upper_bound` that bounds a forward
GEMM bounds a backward one.  :func:`measure_gradient_nsr` runs a
gradient computation under a ``want_float`` tap and returns one record
per backward event with both sides of

    eta_measured  <=  eta_bound        (hard, deterministic)

Taps observe eager execution only: run ``fn`` outside
``Plan.jit_forward``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

import torch

from repro_torch.core.nsr import gemm_nsr_upper_bound
from repro_torch.engine import taps as TAPS

__all__ = ["GradNSRRecord", "BACKWARD_KINDS", "measure_gradient_nsr"]

#: Tap kinds emitted by the backward GEMMs (repro_torch.grad.vjp).
BACKWARD_KINDS = ("gemm_dx", "gemm_dw", "conv_dx", "conv_dw")


@dataclasses.dataclass
class GradNSRRecord:
    """One backward GEMM: measured output NSR against the bound."""

    path: Optional[str]      #: derived grad path ("c1#dx", ...)
    kind: str                #: "gemm_dx" | "gemm_dw" | "conv_dx" | "conv_dw"
    backend: str
    policy: Any              #: the FITTED policy that executed (None=float)
    eta_measured: float
    eta_bound: float         #: inf for float backward GEMMs (no formatting)

    @property
    def within_bound(self) -> bool:
        return self.eta_measured <= self.eta_bound


def measure_gradient_nsr(fn: Callable[[], Any]) -> List[GradNSRRecord]:
    """Run ``fn`` (some eager gradient computation) under a measuring tap.

    Every backward tap event yields one record: ``eta_measured`` is the
    energy ratio ||y - y_float||^2 / ||y_float||^2 of the backward GEMM's
    output against its float reference on the SAME operands
    (``want_float``), ``eta_bound`` the worst-case bound from the block
    geometry of those operands.  Float backward GEMMs measure ~0 and
    carry an infinite bound.  Records come in execution order; forward
    events are ignored.
    """
    records: List[GradNSRRecord] = []
    tiny = torch.finfo(torch.float32).tiny

    def capture(ev: TAPS.TapEvent):
        if ev.kind not in BACKWARD_KINDS:
            return
        yf = ev.y_float
        sig = float(torch.sum(torch.square(yf)))
        err = float(torch.sum(torch.square(ev.y - yf)))
        eta = err / max(sig, tiny)
        bound = (float("inf") if ev.policy is None else
                 float(gemm_nsr_upper_bound(ev.x, ev.w, ev.policy)))
        records.append(GradNSRRecord(ev.path, ev.kind, ev.backend,
                                     ev.policy, eta, bound))

    with TAPS.taps(capture, want_float=True):
        fn()
    return records
