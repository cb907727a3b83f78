"""Engine tap API — observers on the real BFP datapath (counterpart of
``repro.engine.taps``).

A *tap* sees every GEMM / conv the engine executes, with the site
identity the plan/policy machinery already carries:

    def capture(ev):                      # ev: TapEvent
        print(ev.path, ev.kind, ev.backend)

    with engine.taps(capture):
        logits = vgg.apply(params, x, policy)

Events fire from the public entry points — ``engine.gemm``,
``engine.conv2d``, and the bound ``Plan`` equivalents — AFTER the
backend has produced the datapath output, so ``ev.y`` is exactly what
the model sees (pre-bias; biases/norms live in the layers, not the
engine).  A conv site emits ONE conv event whatever the fused-vs-im2col
route: the im2col route's internal GEMM does not fire.

Overhead contract:
  * no taps registered: one truthiness check per engine call — nothing
    else is built or captured;
  * taps registered: events carry references to the live tensors (no
    copies); ``want_float=True`` additionally runs the float reference
    execution of the same site (one extra matmul/conv per event);
  * ``repro`` suppresses events under ``jax.jit`` tracing; here the
    counterpart is ``Plan.jit_forward``, whose forward runs with taps
    suppressed (:func:`suppressed`).  Taps observe eager execution only
    (the Table-4 analysis mode): run the model through ``apply`` (or
    ``CnnServeEngine(jit=False)``) to measure.

The backward GEMMs of ``repro_torch.grad`` emit the backward kinds
(``gemm_dx``, ``gemm_dw``, ``conv_dx``, ``conv_dw``) on their derived
grad paths (``path#dx`` / ``path#dw``), with the operands they executed
(already transposed) and the tile-fitted policy; ``float_fn`` is the
float GEMM on the same operands.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, List, Optional

__all__ = ["TapEvent", "taps", "active"]


@dataclasses.dataclass
class TapEvent:
    """One engine execution, as observed by a tap.

    ``x``/``w``/``y`` are the live operands/output (GEMM: ``x`` with
    leading dims, ``w`` float [K, N] or prequant dict; conv: NHWC input,
    HWIO kernel, NHWC output).  ``y_float`` is the float-reference
    output of the same site, computed only when a registered tap asked
    for it (``want_float=True``); otherwise None.
    """

    path: Optional[str]     #: layer path ("conv1_1", ...)
    kind: str               #: "gemm" | "conv", or a backward kind:
                            #: "gemm_dx" | "gemm_dw" | "conv_dx" |
                            #: "conv_dw"
    policy: Any             #: resolved BFPPolicy (None = float site)
    backend: str            #: name of the backend that executed
    x: Any                  #: tensor, or the activation wire format
    w: Any
    y: Any
    y_float: Any = None
    stride: Optional[int] = None     #: conv only
    padding: Optional[str] = None    #: conv only


@dataclasses.dataclass
class _Tap:
    fn: Callable[[TapEvent], None]
    want_float: bool
    transform: bool = False


_ACTIVE: List[_Tap] = []
#: depth of :func:`suppressed` scopes (``Plan.jit_forward``'s forwards)
_SUPPRESSED = 0


def active() -> bool:
    """True when at least one tap is registered and events are not
    suppressed (cheap per-call guard)."""
    return bool(_ACTIVE) and not _SUPPRESSED


@contextlib.contextmanager
def taps(fn: Callable[[TapEvent], None], *, want_float: bool = False,
         transform: bool = False):
    """Register ``fn`` as a datapath observer for the dynamic extent.

    ``want_float=True`` asks the engine to also execute the float
    reference for every observed site and attach it as ``ev.y_float``
    (costs one extra float execution per event — single-run SNR
    monitoring; the dual-run analysis leaves it off).

    ``transform=True`` promotes the tap from observer to INTERVENER: a
    non-None return value from ``fn`` REPLACES the site's output on the
    live datapath (the fault-injection hook).  Returning None leaves the
    output untouched, so a transforming tap can target a subset of
    sites.  Like all taps, transforms see only eager execution: inside
    ``Plan.jit_forward`` no event fires and the datapath is unchanged.
    """
    t = _Tap(fn, want_float, transform)
    _ACTIVE.append(t)
    try:
        yield t
    finally:
        _ACTIVE.remove(t)


@contextlib.contextmanager
def suppressed():
    """No event fires in the dynamic extent (engine-internal: the port's
    counterpart of ``repro``'s jit tracing, used by
    ``Plan.jit_forward``)."""
    global _SUPPRESSED
    _SUPPRESSED += 1
    try:
        yield
    finally:
        _SUPPRESSED -= 1


def emit(kind: str, path, policy, backend: str, x, w, y,
         float_fn: Optional[Callable[[], Any]] = None,
         stride=None, padding=None):
    """Deliver one event to every registered tap (engine-internal).

    ``float_fn`` lazily produces the float reference output; it runs at
    most once, and only if some tap requested ``want_float``.

    Returns the (possibly transformed) output: identical to ``y`` unless
    some ``transform=True`` tap returned a replacement, in which case
    later taps observe the replaced value and the engine call site
    adopts it (``gemm_and_tap`` / ``conv_and_tap``).
    """
    if not active():
        return y
    y_float = None
    if float_fn is not None and any(t.want_float for t in _ACTIVE):
        y_float = float_fn()
    ev = TapEvent(path=path, kind=kind, policy=policy, backend=backend,
                  x=x, w=w, y=y, y_float=y_float, stride=stride,
                  padding=padding)
    out = y
    for t in list(_ACTIVE):
        r = t.fn(ev)
        if t.transform and r is not None:
            out = r
            ev = dataclasses.replace(ev, y=out)
    return out
