"""Batched CNN inference service on bound BFP plans (counterpart of
``repro.serve.cnn``).

  * a shape-stable slot table (``serve.slots.SlotTable``): image requests
    admit into free slots, finished slots free immediately;
  * iteration-level batching over batch buckets: each step stacks the
    active slots into the smallest fitting bucket, padding with
    duplicates of a live image (rows are independent in every conv and
    GEMM, so a duplicate can never raise a shared block max — logits-
    neutral for any weights); ``batching="bucket"`` keeps the barrier
    baseline that defers partial batches;
  * a bind-once ``engine.Plan``: policy resolution, backend selection
    and weight pre-quantization happen at construction
    (``strict_backend=True`` rejects undeployable configs here);
    engines bound to one plan share one forward (``Plan.jit_forward``),
    or with ``jit=False`` run ``apply`` eagerly so that taps see every
    served site;
  * data-parallel batch sharding through ``dist.sharding.axis_rules`` and
    a ``launch.mesh`` mesh: the stacked batch is annotated
    ``("batch", None, None, None)`` before the forward, as in ``repro``.
    Eager torch has no SPMD partitioner, so the engine does what XLA does
    for ``repro``: where the batch rule resolves to mesh axes of total
    size D > 1, every rank runs the same engine on the same requests,
    takes its rows of the bucket (``distribute_tensor(...).to_local()``),
    runs the forward on them with the weights replicated, and gathers the
    logits (``DTensor.full_tensor()``), so every rank completes every
    request.  Inside that split forward EQ2's and EQ4's whole-matrix
    activation block takes its max over the data group
    (``dist.sharding.batch_group``).  A dropped rule (D does not divide
    the bucket) or D = 1 runs the whole batch with no collective.

Bit-exactness contract: a request served through the engine produces
exactly the logits of a direct ``apply(plan.params, batch, plan)`` on
the same rows, with a mesh or without.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import engine as EG
from repro_torch._device import DeviceLike, resolve_device
from repro_torch.dist import sharding as DS
from repro_torch.engine import PolicyLike
from repro_torch.engine.plan import Plan
from repro_torch.models.cnn import head_logits
from repro_torch.serve.degrade import (DeadlineExceeded, DegradeConfig,
                                       DegradeController, QueueOverloaded,
                                       float_params)
from repro_torch.serve.slots import SlotTable

__all__ = ["ImageRequest", "CnnServeEngine", "default_buckets"]

#: logical axes of an NHWC image batch — only the batch axis shards
#: (pure data parallelism; DEFAULT_RULES maps "batch" -> "data")
_BATCH_AXES = ("batch", None, None, None)


@dataclasses.dataclass
class ImageRequest:
    """One classification request: an [H, W, C] image in, logits out.

    ``deadline`` is an absolute value of the engine's monotonic clock.
    ``error`` is set (and ``logits`` stays None) whenever the request
    failed; ``degraded`` reports which plan served it.
    """

    rid: int
    image: Any                      #: [H, W, C] tensor or array
    logits: Optional[np.ndarray] = None
    label: Optional[int] = None
    done: bool = False
    deadline: Optional[float] = None
    error: Optional[BaseException] = None
    degraded: bool = False


def default_buckets(slots: int) -> Tuple[int, ...]:
    """Powers of two up to ``slots`` (plus ``slots`` itself): 8 -> (1, 2,
    4, 8), 6 -> (1, 2, 4, 6)."""
    out: List[int] = []
    b = 1
    while b < slots:
        out.append(b)
        b *= 2
    out.append(slots)
    return tuple(out)


class CnnServeEngine:
    """Slot-table batched CNN server over a bound execution plan.

    Args follow ``repro.serve.cnn.CnnServeEngine``: ``params`` (ignored,
    and must be None, when ``policy`` is a bound Plan), ``apply_fn``,
    ``policy``, ``slots``, ``buckets``, ``prequant``, ``strict_backend``,
    ``jit``, ``max_queue``, ``fallback_policy``, ``degrade``,
    ``float_retry``, ``batching``, ``max_wait``, ``clock``.  ``device`` is
    where the forwards run (default "cuda"); a pre-bound Plan must live
    there.  ``mesh`` (a ``launch.mesh`` mesh) and ``rules`` (default
    ``dist.sharding.DEFAULT_RULES``): every forward runs under
    ``axis_rules`` with the batch axis sharded (see the module
    docstring); a forward that raises on one rank of the data group
    fails the group on every rank.  ``jit=True`` serves through the plan's shared
    ``Plan.jit_forward`` (taps suppressed, as in ``repro``'s compiled
    forward); ``jit=False`` calls ``apply_fn(plan.params, x, plan)``
    itself, so ``engine.taps`` observe every served site, as ``repro``'s
    eager engine does.  The logits are the same bits either way.
    """

    def __init__(self, params: Any, apply_fn: Callable[..., Any],
                 policy: PolicyLike = None, *, slots: int = 8,
                 buckets: Optional[Sequence[int]] = None,
                 prequant: bool = True, strict_backend: bool = False,
                 mesh=None, rules: Optional[Dict[str, Any]] = None,
                 jit: bool = True, max_queue: Optional[int] = None,
                 fallback_policy: PolicyLike = None,
                 degrade: Optional[DegradeConfig] = None,
                 float_retry: bool = True,
                 batching: str = "continuous", max_wait: int = 4,
                 clock: Callable[[], float] = time.monotonic,
                 device: DeviceLike = "cuda"):
        if batching not in ("continuous", "bucket"):
            raise ValueError(f"batching must be 'continuous' or 'bucket', "
                             f"got {batching!r}")
        if max_wait < 0:
            raise ValueError(f"max_wait must be >= 0, got {max_wait}")
        self.device = resolve_device(device)
        self.batching = batching
        self.max_wait = max_wait
        self._waited = 0   # consecutive bucket-mode deferred steps
        self.plan = self._plan_for(params, policy, strict_backend, prequant)
        self.apply_fn = apply_fn
        self.table = SlotTable(slots)
        self.buckets = (tuple(sorted(buckets)) if buckets
                        else default_buckets(slots))
        if self.buckets[-1] < 1:
            raise ValueError(f"bad buckets {self.buckets}")
        self.mesh = mesh
        self.rules = dict(rules) if rules is not None \
            else dict(DS.DEFAULT_RULES)
        self.jit = jit
        self._fwd = self._make_fwd(self.plan)
        self._shape: Optional[Tuple[int, ...]] = None
        self._next_rid = 0
        self.max_queue = max_queue
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self._clock = clock
        self._float_retry = float_retry
        self._float_fwds: Dict[bool, Callable[..., Any]] = {}
        if fallback_policy is not None:
            if params is None and not isinstance(fallback_policy, Plan):
                raise ValueError(
                    "fallback_policy needs params to bind against; "
                    "pass a pre-bound Plan when reusing policy=Plan")
            self.fallback_plan: Optional[Plan] = self._plan_for(
                params, fallback_policy, strict_backend, prequant)
            self._fb_fwd = self._make_fwd(self.fallback_plan)
            self.controller: Optional[DegradeController] = \
                DegradeController(degrade or DegradeConfig(queue_high=slots))
        else:
            self.fallback_plan = None
            self._fb_fwd = None
            self.controller = (DegradeController(degrade)
                               if degrade is not None else None)
        #: every request ends in exactly one of completed/expired/failed
        #: (shed requests were never enqueued); float_retries and
        #: degraded_served tag HOW completions were served
        self.stats: Dict[str, int] = {"shed": 0, "expired": 0,
                                      "failed": 0, "completed": 0,
                                      "float_retries": 0,
                                      "degraded_served": 0}
        #: total batched forwards issued (retries included)
        self.ncalls = 0

    def _plan_for(self, params, policy, strict: bool,
                  prequant: bool) -> Plan:
        if not isinstance(policy, Plan):
            return EG.bind(params, policy, tree="cnn", strict=strict,
                           prequantize=prequant, device=self.device)
        if params is not None:
            raise ValueError("pass params=None when policy is a bound Plan "
                             "(the plan's params serve)")
        if policy.device != self.device:
            raise ValueError(f"plan bound on {policy.device}, engine device "
                             f"is {self.device}")
        return policy

    def _make_fwd(self, plan: Plan) -> Callable[..., Any]:
        if self.jit:
            return plan.jit_forward(self.apply_fn)

        def fwd(x, _fn=self.apply_fn):
            with torch.inference_mode():
                return _fn(plan.params, x, plan)

        return fwd

    # -- admission ----------------------------------------------------------

    def submit(self, req: Any = None, *, image: Any = None) -> ImageRequest:
        """Queue a request (or wrap a bare ``image=`` into one).  All
        images share one [H, W, C] shape; with ``max_queue`` set a full
        queue sheds the submission with :class:`QueueOverloaded`."""
        if req is None:
            if image is None:
                raise ValueError("pass a request or image=")
            req = ImageRequest(rid=self._next_rid, image=image)
        if self.max_queue is not None and \
                len(self.table.queue) >= self.max_queue:
            self.stats["shed"] += 1
            raise QueueOverloaded(
                f"queue depth {len(self.table.queue)} at limit "
                f"{self.max_queue}; request {req.rid} shed", rid=req.rid)
        self._next_rid = max(self._next_rid, req.rid) + 1
        img = req.image
        if getattr(img, "ndim", 0) != 3:
            raise ValueError(f"image must be [H, W, C], got "
                             f"{getattr(img, 'shape', None)}")
        if self._shape is None:
            self._shape = tuple(img.shape)
        elif tuple(img.shape) != self._shape:
            raise ValueError(f"image shape {tuple(img.shape)} != engine "
                             f"shape {self._shape} (slot table is "
                             f"shape-stable)")
        self.table.submit(req)
        return req

    # -- serving ------------------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _sharding_ctx(self):
        return (DS.axis_rules(self.rules, self.mesh)
                if self.mesh is not None else contextlib.nullcontext())

    def _logits(self, fwd: Callable[..., Any], x: torch.Tensor
                ) -> torch.Tensor:
        """Head-0 logits of ``fwd`` over the bucket ``x``.  Under a mesh
        whose batch rule splits the bucket, this rank's rows run and the
        logits are gathered from the data group."""
        if self.mesh is None:
            return head_logits(fwd(x))
        with self._sharding_ctx():
            x = DS.shard(x, *_BATCH_AXES)
            phys = DS.resolve_spec(self.rules, DS.mesh_axis_sizes(self.mesh),
                                   tuple(x.shape), _BATCH_AXES)
            place = DS.placements(self.mesh, phys)
            dims = [i for i, p in enumerate(place) if p.is_shard()]
            if all(self.mesh.size(i) == 1 for i in dims):
                return head_logits(fwd(x))
            from torch.distributed.tensor import DTensor, distribute_tensor

            groups = [self.mesh.get_group(i) for i in dims]
            xl = distribute_tensor(x, self.mesh, place,
                                   src_data_rank=None).to_local()
            err: Optional[BaseException] = None
            try:
                with DS.batch_group(groups):
                    out = head_logits(fwd(xl)).contiguous()
            except Exception as e:                # noqa: BLE001
                err = out = e
            if DS.any_rank(err is not None, groups, x.device):
                raise err if err is not None else RuntimeError(
                    "the forward raised on another rank of the data group")
            return DTensor.from_local(out, self.mesh, place).full_tensor()

    def _float_fwd(self, degraded: bool) -> Callable[..., Any]:
        """Float-reference forward of the serving plan's own (quantized)
        weights — the non-finite-logits retry path, built lazily."""
        fwd = self._float_fwds.get(degraded)
        if fwd is None:
            plan = self.fallback_plan if degraded else self.plan
            tree = float_params(plan.params, self.device)
            fn = self.apply_fn

            def fwd(x, _t=tree):
                with torch.inference_mode():
                    return fn(_t, x, None)

            self._float_fwds[degraded] = fwd
        return fwd

    def _fail_group(self, group: List[int], reqs: List[ImageRequest],
                    exc: BaseException) -> None:
        """Complete every request of a failed group exceptionally and free
        its slot — a raising forward must never leak slots."""
        for s, r in zip(group, reqs):
            r.error = exc
            r.done = True
            self.stats["failed"] += 1
            self.table.free(s)

    def _expire(self) -> None:
        """Fail every queued or admitted request whose deadline passed
        (before admission, so a dead request never occupies a slot)."""
        now = self._clock()

        def dead(r):
            return r.deadline is not None and now > r.deadline

        expired_q = self.table.retain(lambda r: not dead(r))
        for s in self.table.active():
            r = self.table.req[s]
            if dead(r):
                expired_q.append(r)
                self.table.free(s)
        for r in expired_q:
            r.error = DeadlineExceeded(
                f"request {r.rid} missed deadline {r.deadline}", rid=r.rid)
            r.done = True
            self.stats["expired"] += 1

    def _run_group(self, group: List[int], degraded: bool = False) -> None:
        reqs = [self.table.req[s] for s in group]
        bucket = self._bucket_for(len(reqs))
        imgs = [r.image for r in reqs]
        if len(imgs) < bucket:
            # pad with a DUPLICATE of a live image: logits-neutral for
            # any weights (a zero image is only neutral while zero rows
            # stay zero through biases)
            imgs = imgs + [imgs[0]] * (bucket - len(imgs))
        try:
            x = torch.stack([torch.as_tensor(i) for i in imgs]).to(
                self.device, torch.float32)
            self.ncalls += 1
            logits = self._logits(self._fb_fwd if degraded else self._fwd,
                                  x).float().cpu().numpy()
            if self._float_retry and \
                    not np.all(np.isfinite(logits[:len(reqs)])):
                # one retry on the float reference of the SAME weights
                self.stats["float_retries"] += 1
                self.ncalls += 1
                logits = self._logits(self._float_fwd(degraded),
                                      x).float().cpu().numpy()
        except Exception as e:                    # noqa: BLE001 — slots
            self._fail_group(group, reqs, e)      # must never leak
            return
        for i, (s, r) in enumerate(zip(group, reqs)):
            r.logits = logits[i]
            r.label = int(np.argmax(logits[i]))
            r.done = True
            r.degraded = degraded
            self.stats["completed"] += 1
            if degraded:
                self.stats["degraded_served"] += 1
            self.table.free(s)

    def step(self) -> int:
        """One engine iteration; returns the number of requests still
        queued or in flight AFTER the step (0 == drained), so
        ``while eng.step(): ...`` serves to completion.  Order: the
        controller observes the pre-admission queue depth, expiry runs
        before admission, then the active slots run (continuous mode) or
        wait behind the bucket barrier (``batching="bucket"``)."""
        degraded = False
        if self.controller is not None:
            state = self.controller.observe(len(self.table.queue))
            degraded = (state == DegradeController.DEGRADED and
                        self._fb_fwd is not None)
        self._expire()
        self.table.admit()
        active = self.table.active()
        if not active:
            return self.table.pending()
        cap = self.buckets[-1]
        if self.batching == "bucket" and len(active) < cap and \
                self._waited < self.max_wait:
            self._waited += 1
            return self.table.pending()
        self._waited = 0
        for i in range(0, len(active), cap):
            self._run_group(active[i:i + cap], degraded=degraded)
        return self.table.pending()

    def run(self) -> List[Any]:
        """Drain the queue; returns the requests in flight or queued when
        called."""
        all_reqs = [self.table.req[s] for s in self.table.active()] + \
            list(self.table.queue)
        while self.table.pending():
            self.step()
        return all_reqs
