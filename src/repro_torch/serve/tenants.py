"""Multi-tenant CNN serving: several model-zoo entries in one process
(counterpart of ``repro.serve.tenants``).

Each tenant of a :class:`MultiTenantServer` is an independent
``serve.cnn.CnnServeEngine`` (own slot table, queue, deadlines, degrade
state) over a shared serving substrate:

  * **packed cold start** (:func:`cold_start`): a tenant boots from a
    ``bfp_packed`` checkpoint (``checkpoint.store``) without ever
    materializing float weights for the prequant-eligible sites — the
    restore template is the registered ``init`` on the meta device
    (shapes only, nothing drawn), ``restore(..., packed="keep")`` hands
    back :class:`~repro_torch.core.packed.PackedBFP` leaves, and
    ``engine.bind`` unpacks them straight into ``{"m", "s"}`` sidecars
    on the engine's device;
  * **shared forwards**: ``add_tenant(..., plan=other.plan)`` binds a
    tenant to an existing :class:`~repro_torch.engine.plan.Plan`; both
    engines then dispatch through the one ``plan.jit_forward(apply_fn)``
    callable cached on that plan;
  * **aggregate accounting**: :meth:`MultiTenantServer.stats` merges the
    per-engine counters (completed / expired / failed / shed /
    float_retries / degraded_served) across tenants.

The server steps tenants round-robin; each engine keeps its own
iteration-level batching, so one tenant's long queue never blocks
another tenant's traffic.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.checkpoint import store as CK
from repro_torch.engine.plan import Plan
from repro_torch.models.cnn import MODELS, CnnSpec
from repro_torch.serve.cnn import CnnServeEngine, ImageRequest

__all__ = ["cold_start", "Tenant", "MultiTenantServer"]


def cold_start(model: str, checkpoint_dir: str, *, reduced: bool = True,
               step: Optional[int] = None, num_classes: int = 10,
               device: DeviceLike = "cuda") -> Any:
    """Load a tenant's params from a ``bfp_packed`` artifact, float-free.

    The restore template is the registered ``init`` on the meta device —
    shapes only, so cold start never runs (or allocates) the float
    weight init — and ``packed="keep"`` returns the serialized
    :class:`PackedBFP` containers as they are, for ``engine.bind`` to
    unpack into sidecars.  Leaves the artifact stores float (biases, BN
    terms, odd-K weights) land on ``device``.  Raises
    ``FileNotFoundError`` when the directory holds no valid checkpoint (a
    silently re-initialized tenant would serve garbage logits).
    """
    dev = resolve_device(device)
    spec = MODELS[model]
    template = spec.init(torch.Generator(), reduced=reduced,
                         num_classes=num_classes, device="meta")
    params, _ = CK.restore(checkpoint_dir, template, step=step,
                           packed="keep", device=dev)
    if params is None:
        raise FileNotFoundError(
            f"no valid checkpoint for tenant model {model!r} under "
            f"{checkpoint_dir}")
    return params


@dataclasses.dataclass
class Tenant:
    """One served model: a name, its spec, and its engine.

    ``engine.plan`` is the bound execution plan; tenants constructed
    with ``plan=`` share that object (and its forward) with their donor.
    """

    name: str
    model: str
    spec: CnnSpec
    engine: CnnServeEngine

    @property
    def plan(self) -> Plan:
        return self.engine.plan


class MultiTenantServer:
    """Round-robin host for independent per-tenant serve engines.

    Engine-level args (``jit``, ``clock``, ``device`` and any
    ``CnnServeEngine`` kwarg) set server-wide defaults at construction;
    ``add_tenant`` may override them per tenant.
    """

    def __init__(self, *, clock: Callable[[], float] = time.monotonic,
                 **engine_defaults: Any):
        self._defaults = dict(engine_defaults)
        self._defaults.setdefault("clock", clock)
        self.tenants: Dict[str, Tenant] = {}

    def __getitem__(self, name: str) -> Tenant:
        return self.tenants[name]

    def add_tenant(self, name: str, model: str, *,
                   checkpoint_dir: Optional[str] = None,
                   params: Any = None,
                   policy: Any = None,
                   plan: Optional[Plan] = None,
                   reduced: bool = True,
                   num_classes: int = 10,
                   **engine_kwargs: Any) -> Tenant:
        """Register a tenant serving ``models.cnn.MODELS[model]``.

        Weight source, exactly one of:
          * ``plan=`` — an already-bound Plan (typically another
            tenant's): the engine reuses its params, backend selection
            and ``jit_forward`` callable;
          * ``checkpoint_dir=`` — packed cold start via
            :func:`cold_start` (no float materialization);
          * ``params=`` — an in-memory tree.

        ``policy`` (BFPPolicy / PolicyMap) applies to the latter two and
        is bound here, once.
        """
        if name in self.tenants:
            raise ValueError(f"tenant {name!r} already registered")
        spec = MODELS[model]
        kw = dict(self._defaults)
        kw.update(engine_kwargs)
        if plan is not None:
            if params is not None or checkpoint_dir is not None:
                raise ValueError("pass plan= alone: the plan's params "
                                 "serve (bind-once, serve-many)")
            kw.setdefault("device", plan.device)
            eng = CnnServeEngine(None, spec.apply, plan, **kw)
        else:
            if checkpoint_dir is not None:
                if params is not None:
                    raise ValueError("pass either checkpoint_dir= or "
                                     "params=, not both")
                params = cold_start(model, checkpoint_dir,
                                    reduced=reduced,
                                    num_classes=num_classes,
                                    device=kw.get("device", "cuda"))
                # packed leaves carry their quantization; the float leaves
                # of a packed artifact stay float
                kw.setdefault("prequant", False)
            eng = CnnServeEngine(params, spec.apply, policy, **kw)
        t = Tenant(name=name, model=model, spec=spec, engine=eng)
        self.tenants[name] = t
        return t

    # -- serving ------------------------------------------------------------

    def submit(self, tenant: str, req: Any = None, *,
               image: Any = None) -> ImageRequest:
        """Queue a request on ``tenant`` (typed rejections propagate)."""
        return self.tenants[tenant].engine.submit(req, image=image)

    def step(self) -> int:
        """One round-robin pass — each tenant's engine steps once;
        returns the requests still queued or in flight across tenants
        (the drive-loop contract of a single engine)."""
        return sum(t.engine.step() for t in self.tenants.values())

    def run(self) -> List[Any]:
        """Drain every tenant; returns the requests that were in flight
        or queued when called (per-tenant snapshot, tenant order)."""
        out: List[Any] = []
        for t in self.tenants.values():
            out.extend(t.engine.table.req[s]
                       for s in t.engine.table.active())
            out.extend(t.engine.table.queue)
        while self.step():
            pass
        return out

    def pending(self) -> int:
        return sum(t.engine.table.pending() for t in self.tenants.values())

    def stats(self) -> Dict[str, Any]:
        """Per-tenant counters plus a cross-tenant ``total`` roll-up."""
        per = {n: dict(t.engine.stats) for n, t in self.tenants.items()}
        total: Dict[str, int] = {}
        for s in per.values():
            for k, v in s.items():
                total[k] = total.get(k, 0) + v
        return {"tenants": per, "total": total}
