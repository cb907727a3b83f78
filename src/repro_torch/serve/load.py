"""Open-loop synthetic load for the serve engines (counterpart of
``repro.serve.load``).

Closed-loop drivers (submit, drain, repeat) can never see a bucket
barrier: the offered load adapts to the server, so queueing delay hides
inside the driver.  This module generates OPEN-LOOP traffic — arrivals
fire at their scheduled times whether or not the server kept up, the
standard methodology for tail-latency measurement — and drives an engine
through it on a virtual clock:

  * :func:`poisson_arrivals` — a seeded Poisson process (exponential
    inter-arrival gaps) over a weighted mix of request kinds, each kind
    carrying its own payload shape and relative deadline.  Deterministic
    given ``seed``: a trace replays exactly on any machine;
  * :class:`VirtualClock` — the injectable engine clock the driver owns.
    Time advances by ``call_cost`` per engine call
    (``engine.ncalls``, one batched CNN
    forward = one unit of accelerator occupancy — machine-independent),
    or by measured wall time when ``call_cost=None``.  A step that
    issues NO calls (a bucket-mode deferral, an empty table) idles the
    server: the clock jumps to the next arrival, which is exactly how a
    barrier turns idle hope into tail latency;
  * :func:`run_open_loop` — submits due arrivals, steps the engine,
    collects completions, and folds everything into a :class:`LoadReport`
    (p50/p99/mean latency, goodput, shed/expired/failed counts, degraded
    service) whose :meth:`~LoadReport.row` is one JSON-safe record.

The engine must be constructed with ``clock=<the VirtualClock>`` so
deadline expiry sees the same timeline the driver advances.

The traces, the accounting and the virtual-time reports are ``repro``'s
(same ``RandomState`` stream, same arithmetic), so one trace under
``call_cost`` gives the same :meth:`LoadReport.row` in both packages.
Wall time on the card (``call_cost=None``) is honest because
``CnnServeEngine`` copies each batch's logits to the host inside its
step (``serve.cnn``'s ``_run_group``): a step returns only after its
kernels have finished, so the host clock around it sees the device
time.  Keep that synchronization if the engine changes.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.degrade import DeadlineExceeded, ServeRejected

__all__ = ["Arrival", "poisson_arrivals", "VirtualClock", "LoadReport",
           "run_open_loop"]


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One scheduled request: WHEN it fires and WHAT shape it is.

    ``payload`` is the kind's free-form shape description (prompt
    length, image index, ...) consumed by the caller's request
    factory; ``deadline`` is RELATIVE to ``t`` (None = no deadline).
    """

    t: float
    rid: int
    kind: str
    payload: Dict[str, Any]
    deadline: Optional[float] = None


def poisson_arrivals(rate: float, n: int,
                     mix: Sequence[Tuple[float, str, Dict[str, Any]]],
                     *, seed: int = 0,
                     start: float = 0.0) -> List[Arrival]:
    """``n`` Poisson arrivals at ``rate`` per unit time over a kind mix.

    ``mix`` rows are ``(weight, kind, payload)``; a payload may carry a
    ``"deadline"`` key (relative seconds) which is lifted onto the
    :class:`Arrival`.  Sampling is ``numpy.random.RandomState(seed)`` —
    fully deterministic, so a trace replays bit-identical
    traffic anywhere.
    """
    if rate <= 0:
        raise ValueError(f"rate must be > 0, got {rate}")
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    if not mix:
        raise ValueError("mix must be non-empty")
    rng = np.random.RandomState(seed)
    gaps = rng.exponential(1.0 / rate, size=n)
    ts = start + np.cumsum(gaps)
    weights = np.asarray([w for w, _, _ in mix], dtype=np.float64)
    weights = weights / weights.sum()
    picks = rng.choice(len(mix), size=n, p=weights)
    out: List[Arrival] = []
    for i in range(n):
        _, kind, payload = mix[int(picks[i])]
        payload = dict(payload)
        deadline = payload.pop("deadline", None)
        out.append(Arrival(t=float(ts[i]), rid=i, kind=kind,
                           payload=payload, deadline=deadline))
    return out


class VirtualClock:
    """A monotonic clock the load driver owns (inject as ``clock=``)."""

    def __init__(self, t0: float = 0.0):
        self.t = t0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"clock cannot run backwards (dt={dt})")
        self.t += dt


@dataclasses.dataclass
class LoadReport:
    """Everything one open-loop run says about a serving configuration.

    ``goodput_rps`` counts only requests that completed SUCCESSFULLY
    (shed, expired, and failed ones all consumed capacity without
    producing an answer — that is the overload story the report exists
    to tell), per unit of virtual time.
    """

    offered: int
    completed: int
    shed: int
    expired: int
    failed: int
    degraded_served: int
    float_retries: int
    p50_ms: float
    p99_ms: float
    mean_ms: float
    duration_s: float
    goodput_rps: float
    steps: int
    calls: int
    #: per-request-kind latency/outcome breakdown — the aggregate p99
    #: of a mixed workload is owned by its slowest kind, so the
    #: scheduling question ("who pays for the barrier?") needs the
    #: split: {"short": {"completed", "expired", "p50_ms", "p99_ms",
    #: "mean_ms"}, ...}
    kinds: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)

    def row(self) -> Dict[str, Any]:
        """JSON-safe dict of the report, floats rounded to 6 places."""
        def clean(v):
            if isinstance(v, float):
                return round(v, 6)
            if isinstance(v, dict):
                return {k: clean(x) for k, x in v.items()}
            return v

        return {k: clean(v) for k, v in
                dataclasses.asdict(self).items()}


def run_open_loop(engine: Any, arrivals: Sequence[Arrival],
                  make_request: Callable[[Arrival], Any],
                  *, clock: VirtualClock,
                  call_cost: Optional[float] = None,
                  timer: Callable[[], float] = time.perf_counter,
                  max_steps: int = 1_000_000) -> LoadReport:
    """Drive ``engine`` through ``arrivals`` open-loop; returns the report.

    ``make_request(arrival)`` builds the engine's request object — it
    must set the ABSOLUTE deadline (``arrival.t + arrival.deadline``)
    itself, and the engine must share this ``clock``.  ``call_cost``
    switches the timeline to deterministic virtual time (seconds per
    ``engine.ncalls`` unit); None measures wall time per step, for
    real-machine numbers.  Works with any engine exposing
    ``submit`` / ``step`` / ``table.pending()`` / ``ncalls`` / ``stats``
    — ``CnnServeEngine`` and :class:`~repro_torch.serve.tenants
    .MultiTenantServer` tenants qualify.
    """
    todo = deque(sorted(arrivals, key=lambda a: a.t))
    offered = len(todo)
    inflight: List[Tuple[Arrival, Any]] = []
    lat: List[float] = []
    by_kind: Dict[str, List[float]] = {}
    exp_kind: Dict[str, int] = {}
    shed = expired = failed = steps = 0
    calls0 = engine.ncalls
    t0 = clock.t
    while todo or engine.table.pending():
        while todo and todo[0].t <= clock.t:
            a = todo.popleft()
            try:
                req = make_request(a)
                engine.submit(req)
                inflight.append((a, req))
            except ServeRejected:
                shed += 1
        if not engine.table.pending():
            if not todo:
                break
            # server idle, future arrivals pending: jump to the next one
            clock.t = max(clock.t, todo[0].t)
            continue
        c0 = engine.ncalls
        w0 = timer()
        engine.step()
        steps += 1
        dcalls = engine.ncalls - c0
        if dcalls == 0:
            # no accelerator work issued (bucket-mode deferral): the
            # server sits idle until traffic moves it — model that as a
            # jump to the next arrival, the latency cost of a barrier
            if todo:
                clock.t = max(clock.t, todo[0].t)
        elif call_cost is not None:
            clock.advance(dcalls * call_cost)
        else:
            clock.advance(max(0.0, timer() - w0))
        still: List[Tuple[Arrival, Any]] = []
        for a, r in inflight:
            if not r.done:
                still.append((a, r))
            elif r.error is None:
                lat.append(clock.t - a.t)
                by_kind.setdefault(a.kind, []).append(clock.t - a.t)
            elif isinstance(r.error, DeadlineExceeded):
                expired += 1
                exp_kind[a.kind] = exp_kind.get(a.kind, 0) + 1
            else:
                failed += 1
        inflight = still
        if steps >= max_steps:
            raise RuntimeError(f"load run exceeded {max_steps} steps "
                               f"({len(inflight)} in flight, "
                               f"{len(todo)} arrivals to go)")
    duration = max(clock.t - t0, 1e-9)
    arr = np.asarray(lat) if lat else np.zeros((0,))
    kinds: Dict[str, Dict[str, float]] = {}
    for k in sorted(set(by_kind) | set(exp_kind)):
        ks = np.asarray(by_kind.get(k, []))
        kinds[k] = {
            "completed": int(ks.size),
            "expired": exp_kind.get(k, 0),
            "p50_ms": float(np.percentile(ks, 50) * 1e3) if ks.size
            else 0.0,
            "p99_ms": float(np.percentile(ks, 99) * 1e3) if ks.size
            else 0.0,
            "mean_ms": float(ks.mean() * 1e3) if ks.size else 0.0,
        }
    return LoadReport(
        offered=offered, completed=len(lat), shed=shed, expired=expired,
        failed=failed,
        degraded_served=engine.stats.get("degraded_served", 0),
        float_retries=engine.stats.get("float_retries", 0),
        p50_ms=float(np.percentile(arr, 50) * 1e3) if lat else 0.0,
        p99_ms=float(np.percentile(arr, 99) * 1e3) if lat else 0.0,
        mean_ms=float(arr.mean() * 1e3) if lat else 0.0,
        duration_s=float(duration),
        goodput_rps=len(lat) / duration,
        steps=steps, calls=engine.ncalls - calls0, kinds=kinds)
