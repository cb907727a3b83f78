"""Graceful degradation for the serve engines (counterpart of
``repro.serve.degrade``).

  * typed rejections / request errors (:class:`ServeRejected` tree) —
    shedding and expiry are API results, not stack traces;
  * the :class:`DegradeController` state machine — PRIMARY -> (queue
    depth >= high watermark for ``trip_steps`` consecutive steps) ->
    DEGRADED -> (depth <= low watermark for ``recover_steps`` steps) ->
    PRIMARY, with hysteresis on both edges;
  * :func:`float_params` — the float-retry weight tree: prequant
    ``{"m", "s"}`` sidecars and packed containers dequantize to dense
    float32.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch import _tree
from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core import packed as PK
from repro_torch.core import prequant as PQ

__all__ = ["ServeRejected", "QueueOverloaded", "DeadlineExceeded",
           "RequestTooLarge", "DegradeConfig", "DegradeController",
           "float_params"]


class ServeRejected(RuntimeError):
    """Base of every typed serving rejection; carries the request id."""

    def __init__(self, msg: str, rid: Optional[int] = None):
        super().__init__(msg)
        self.rid = rid


class QueueOverloaded(ServeRejected):
    """Submission shed: the engine queue is at its depth limit (raised by
    ``submit``; the request was never enqueued)."""


class DeadlineExceeded(ServeRejected):
    """The request's deadline passed before its logits were produced
    (delivered as ``req.error``, never raised through the step loop)."""


class RequestTooLarge(ServeRejected):
    """The request cannot fit the LM engine's cache geometry: raised by
    ``submit`` when ``len(prompt) + max_new > max_len`` (the request was
    never enqueued).  Decode positions past ``max_len`` would write
    outside the KV cache, so the request is refused at the door."""


@dataclasses.dataclass(frozen=True)
class DegradeConfig:
    """Watermarks and hysteresis for :class:`DegradeController`."""

    queue_high: int = 8       #: depth >= this counts as an overloaded step
    queue_low: int = 0        #: depth <= this counts as a drained step
    trip_steps: int = 2       #: consecutive overloaded steps to degrade
    recover_steps: int = 2    #: consecutive drained steps to recover

    def __post_init__(self):
        if self.queue_high < 1:
            raise ValueError(f"queue_high must be >= 1, got "
                             f"{self.queue_high}")
        if not 0 <= self.queue_low < self.queue_high:
            raise ValueError(f"need 0 <= queue_low < queue_high, got "
                             f"{self.queue_low} / {self.queue_high}")
        if self.trip_steps < 1 or self.recover_steps < 1:
            raise ValueError("trip_steps and recover_steps must be >= 1")


class DegradeController:
    """Hysteretic two-state (PRIMARY / DEGRADED) admission controller.

    ``observe(queue_depth)`` is called once per engine step with the
    depth BEFORE admission and returns the state new admissions use.
    """

    PRIMARY = "primary"
    DEGRADED = "degraded"

    def __init__(self, cfg: DegradeConfig):
        self.cfg = cfg
        self.state = self.PRIMARY
        self.trips = 0
        self.recoveries = 0
        self._over = 0
        self._under = 0

    @property
    def degraded(self) -> bool:
        return self.state == self.DEGRADED

    def observe(self, queue_depth: int) -> str:
        if self.state == self.PRIMARY:
            self._over = self._over + 1 if queue_depth >= \
                self.cfg.queue_high else 0
            if self._over >= self.cfg.trip_steps:
                self.state = self.DEGRADED
                self.trips += 1
                self._over = 0
        else:
            self._under = self._under + 1 if queue_depth <= \
                self.cfg.queue_low else 0
            if self._under >= self.cfg.recover_steps:
                self.state = self.PRIMARY
                self.recoveries += 1
                self._under = 0
        return self.state


def float_params(params: Any, device: DeviceLike = "cuda") -> Any:
    """A serving param tree with every prequant sidecar (conv HWIO
    mantissas with GEMM-view steps included) and every
    :class:`~repro_torch.core.packed.PackedBFP` leaf dequantized to dense
    float32 — the float reference of EXACTLY the weights the BFP path
    serves, which the non-finite-logits retry runs with ``policy=None``.
    Sidecars dequantize where they live; containers (host bytes) on
    ``device``, which is resolved only when the tree holds one.
    """
    def one(_, leaf):
        if PK.is_packed(leaf):
            return PK.unpack_dequant(leaf, resolve_device(device))
        if PQ.is_prequant(leaf):
            m, s = leaf["m"], leaf["s"]
            if m.ndim == 4 and s.ndim == 2:      # conv HWIO mantissa
                kh, kw, c, n = m.shape
                d = PQ.dequantize_prequant({"m": m.reshape(kh * kw * c, n),
                                            "s": s})
                return d.reshape(kh, kw, c, n).to(torch.float32)
            return PQ.dequantize_prequant(leaf)
        return leaf

    return _tree.map_with_path(
        one, params, is_leaf=lambda x: PK.is_packed(x) or PQ.is_prequant(x))
