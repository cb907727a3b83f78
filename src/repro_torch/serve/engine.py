"""Batched LM serving of the port (counterpart of ``repro.serve.engine``):
prefill + decode with KV caches and recurrent states.

``generate`` drives ``decode_step`` over N tokens, greedy or sampled; an
encoder-decoder runs its encoder once at ``prefill`` (``enc_feats=``).
``ServeEngine`` (every family but the encoder-decoder) adds
iteration-level (continuous) batching: a slot table where finished
sequences are replaced by queued requests between decode steps, with
prefill CHUNKED INTO THE STEP LOOP (an admission consumes at
most ``prefill_chunk`` prompt tokens per engine step, so a long prompt
never stalls in-flight decodes); ``batching="bucket"`` keeps the
blocking-prefill baseline.  Weight pre-quantization (``prequant=``, or a
tree that already holds ``{"m", "s"}`` sidecars or packed containers)
runs once at construction, and ``policy`` is bound into an
``engine.Plan`` there (``self.plan``): rule resolution and backend
selection happen once, at admission-time weight load, and
``strict_backend=True`` rejects a config whose requested backend cannot
honour the policy.

Where the reference jits the whole-batch step, the port runs
``decode_step`` eagerly under ``torch.inference_mode()`` (tap events
suppressed, as the reference's compiled step emits none); ``prefill`` is
a Python loop over ``decode_step`` (so the hybrid's conv history, which
the first step promotes from bf16 to f32, needs no fixed carry type:
the reference's scan cannot carry it, R8).  Greedy decoding is the
reference's token for token; ``temperature > 0`` samples from a
``torch.Generator`` (``jax.random`` streams cannot be reproduced).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import _tree
from repro_torch import engine as EG
from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import LMConfig
from repro_torch.engine import PolicyLike
from repro_torch.engine.plan import params_to
from repro_torch.engine.taps import suppressed
from repro_torch.models.lm import model as Mdl
from repro_torch.serve.degrade import (DeadlineExceeded, DegradeConfig,
                                       DegradeController, QueueOverloaded,
                                       RequestTooLarge, float_params)
from repro_torch.serve.slots import SlotTable

__all__ = ["prefill", "generate", "ServeEngine", "Request"]


def prefill(params, cfg: LMConfig, tokens: torch.Tensor, cache,
            policy: PolicyLike = None, enc_feats=None,
            device: DeviceLike = "cuda"):
    """Sequential prefill through ``decode_step`` (one call per prompt
    position; state-correct for every family).  tokens: [B, S_prompt].
    An encoder-decoder with ``enc_feats`` [B, S_enc, D] runs its encoder
    first (``prefill_encoder``) into the cache's ``"enc_out"``.  Returns
    (cache, last_logits)."""
    dev = resolve_device(device)
    tokens = torch.as_tensor(tokens).to(dev)
    if cfg.is_encdec and enc_feats is not None:
        with torch.inference_mode():
            enc_out = Mdl.prefill_encoder(
                params, cfg, torch.as_tensor(enc_feats).to(dev), policy)
        cache = dict(cache, enc_out=enc_out)
    logits = torch.zeros((tokens.shape[0], 1, cfg.vocab_size),
                         dtype=torch.float32, device=dev)
    with torch.inference_mode():
        for t in range(tokens.shape[1]):
            logits, cache = Mdl.decode_step(params, cfg, cache,
                                            tokens[:, t:t + 1], t, policy)
    return cache, logits


def generate(params, cfg: LMConfig, prompt, max_new: int,
             policy: PolicyLike = None, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None, enc_feats=None,
             max_len: Optional[int] = None,
             device: DeviceLike = "cuda") -> torch.Tensor:
    """Greedy (``temperature <= 0``) or sampled generation.  Returns
    [B, max_new] token ids on ``device``.  ``enc_feats``: the
    encoder-decoder's frame embeddings [B, S_enc, D] (see
    :func:`prefill`)."""
    dev = resolve_device(device)
    prompt = torch.as_tensor(prompt).to(dev)
    b, s = prompt.shape
    max_len = max_len or (s + max_new)
    cache = Mdl.init_cache(cfg, b, max_len, device=dev)
    cache, logits = prefill(params, cfg, prompt, cache, policy, enc_feats,
                            device=dev)

    def sample(logits):
        lg = logits[:, -1].to(torch.float32)
        if temperature <= 0.0:
            return torch.argmax(lg, -1)
        probs = torch.softmax(lg / temperature, -1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    out = [sample(logits)]
    with torch.inference_mode():
        for i in range(1, max_new):
            logits, cache = Mdl.decode_step(params, cfg, cache,
                                            out[-1][:, None], s + i, policy)
            out.append(sample(logits))
    return torch.stack(out, dim=1)


# ---------------------------------------------------------------------------
# Iteration-level continuous batching
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    #: absolute engine-clock deadline; missing it completes the request
    #: exceptionally (``error`` = DeadlineExceeded) with partial ``out``
    deadline: Optional[float] = None
    error: Optional[BaseException] = None
    #: True when the request was admitted onto the lower-L fallback plan
    degraded: bool = False


class ServeEngine:
    """Slot-table batched LM server (shape-stable whole-batch decode).

    Args follow ``repro.serve.engine.ServeEngine``: ``params``, ``cfg``,
    ``slots``, ``max_len``, ``policy``, ``prequant``, ``strict_backend``,
    ``max_queue``, ``fallback_policy``, ``degrade``, ``float_retry``,
    ``batching``, ``prefill_chunk``, ``clock``; ``device`` is where the
    weights, the cache and the steps live (default "cuda").

    Continuous batching (the default): every :meth:`step` expires,
    admits and advances; a prefilling slot consumes at most
    ``prefill_chunk`` prompt tokens per step while active slots decode
    one token, in the same whole-batch calls wherever positions
    coincide.  ``batching="bucket"`` prefills a whole prompt at
    admission before any active slot advances.  Row independence makes
    both modes bit-identical per request to solo serving: each slot's
    cache rows only ever see its own tokens at its own positions.
    """

    def __init__(self, params, cfg: LMConfig, slots: int = 4,
                 max_len: int = 512, policy: PolicyLike = None,
                 prequant: PolicyLike = None, strict_backend: bool = False,
                 max_queue: Optional[int] = None,
                 fallback_policy: PolicyLike = None,
                 degrade: Optional[DegradeConfig] = None,
                 float_retry: bool = True, batching: str = "continuous",
                 prefill_chunk: Optional[int] = 8,
                 clock: Callable[[], float] = time.monotonic,
                 device: DeviceLike = "cuda"):
        if cfg.is_encdec:
            # decode-only slot engine: no encoder prefill path
            raise ValueError("ServeEngine does not serve encoder-decoder "
                             "configs; use serve.generate with enc_feats")
        if batching not in ("continuous", "bucket"):
            raise ValueError(f"batching must be 'continuous' or 'bucket', "
                             f"got {batching!r}")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1 or None, got "
                             f"{prefill_chunk}")
        self.device = dev = resolve_device(device)
        # packed artifacts unpack straight into {"m", "s"} sidecars
        params = params_to(EG.unpack_packed(params, dev), dev)
        if prequant is not None:
            # block-format once here; every later GEMM reads the sidecars
            params = EG.prequantize(params, prequant)
        # admission-time bind: every site's rule and backend, once
        self.plan = EG.bind(params, policy, tree="lm", strict=strict_backend,
                            prequantize=False, device=dev)
        self.params, self.cfg, self.policy = self.plan.params, cfg, self.plan
        self.slots = slots
        self.max_len = max_len
        self.batching = batching
        self.prefill_chunk = prefill_chunk
        self.cache = Mdl.init_cache(cfg, slots, max_len, device=dev)
        #: pristine per-slot state for admission-time row resets
        self._cache0 = self.cache
        self.table = SlotTable(slots)
        self.slot_req: List[Optional[Request]] = self.table.req
        self.slot_pos = [0] * slots
        #: prompt tokens already consumed by the slot's occupant; a slot
        #: with ``slot_fed < len(prompt)`` is still prefilling
        self.slot_fed = [0] * slots
        self.queue = self.table.queue
        self._step = self._make_step(self.params, self.plan)

        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_queue = max_queue
        self._clock = clock
        self._float_retry = float_retry
        self._float_step = None
        #: per-slot plan tag: True = this slot decodes on the fallback
        #: plan for its whole lifetime
        self.slot_deg: List[bool] = [False] * slots
        if fallback_policy is not None:
            self.fallback_plan = EG.bind(params, fallback_policy, tree="lm",
                                         strict=strict_backend,
                                         prequantize=False, device=dev)
            self._step_fb = self._make_step(self.params, self.fallback_plan)
            self.controller: Optional[DegradeController] = \
                DegradeController(degrade or DegradeConfig(queue_high=slots))
        else:
            self.fallback_plan = None
            self._step_fb = None
            self.controller = (DegradeController(degrade)
                               if degrade is not None else None)
        self.stats: Dict[str, int] = {"shed": 0, "expired": 0,
                                      "failed": 0, "completed": 0,
                                      "float_retries": 0,
                                      "degraded_served": 0}
        #: total whole-batch decode calls issued (prefill + decode +
        #: retries) — the load harness's machine-independent time unit
        self.ncalls = 0

    def _make_step(self, params, policy):
        cfg = self.cfg

        def step(cache, tok, pos):
            with torch.inference_mode(), suppressed():
                return Mdl.decode_step(params, cfg, cache, tok, pos, policy)

        return step

    def submit(self, req: Request):
        """Queue a request, validating it against the cache geometry:
        an empty prompt, ``max_new < 1`` and a request that cannot fit
        the cache (:class:`RequestTooLarge`) are refused before the
        queue-depth check (:class:`QueueOverloaded`)."""
        if not req.prompt:
            raise ValueError("request prompt must be non-empty")
        if req.max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {req.max_new} "
                             f"(the decode loop always emits a token)")
        if len(req.prompt) + req.max_new > self.max_len:
            raise RequestTooLarge(
                f"request {req.rid}: len(prompt)={len(req.prompt)} + "
                f"max_new={req.max_new} exceeds the cache length "
                f"{self.max_len}", rid=req.rid)
        if self.max_queue is not None and \
                len(self.table.queue) >= self.max_queue:
            self.stats["shed"] += 1
            raise QueueOverloaded(
                f"queue depth {len(self.table.queue)} at limit "
                f"{self.max_queue}; request {req.rid} shed", rid=req.rid)
        self.table.submit(req)

    def _merge_rows(self, old, new, rows):
        """Keep only slot ``rows`` of the stepped cache; every other
        slot's rows come from ``old``.  The slot axis is dim 1 of every
        cache leaf, at any depth of the tree (the hybrid's cache nests
        ``{"rec1": {"h", "hist"}, ...}``); each leaf's dtype is the
        promotion of both, as ``jnp.where`` gives it (a bf16 conv
        history merged with a stepped f32 one comes back f32)."""
        sel = torch.zeros(self.slots, dtype=torch.bool)
        sel[list(rows)] = True
        sel = sel.to(self.device)

        def one(o, n):
            dt = torch.promote_types(o.dtype, n.dtype)
            keep = sel.reshape(1, self.slots, *[1] * (o.ndim - 2))
            return torch.where(keep, n.to(dt), o.to(dt))

        return _tree.tree_map(one, old, new)

    def _tokens(self, tok_of: Dict[int, int]) -> torch.Tensor:
        """[slots, 1] token ids: ``tok_of[s]`` in row s, 0 elsewhere."""
        toks = [0] * self.slots
        for s, tok in tok_of.items():
            toks[s] = int(tok)
        return torch.tensor(toks, dtype=torch.long,
                            device=self.device)[:, None]

    def _float_step_fn(self):
        """Lazily built float-reference decode step (retry path): the
        float weights of exactly what the BFP path serves."""
        if self._float_step is None:
            self._float_step = self._make_step(
                float_params(self.params, self.device), None)
        return self._float_step

    def _fail_slots(self, slots: List[int], exc: BaseException) -> None:
        """Complete the requests in ``slots`` exceptionally and free them
        — a raising step must never leak slots."""
        for s in slots:
            req = self.slot_req[s]
            if req is None:
                continue
            req.error = exc
            req.done = True
            self.stats["failed"] += 1
            self.table.free(s)

    def _expire(self) -> None:
        """Fail queued or decoding requests whose deadline passed (their
        partial ``out`` stays); runs before admission, so a dead queued
        request is never admitted or prefilled."""
        now = self._clock()

        def dead(r):
            return r.deadline is not None and now > r.deadline

        expired = self.table.retain(lambda r: not dead(r))
        for s in self.table.active():
            r = self.slot_req[s]
            if dead(r):
                expired.append(r)
                self.table.free(s)
        for r in expired:
            r.error = DeadlineExceeded(
                f"request {r.rid} missed deadline {r.deadline}", rid=r.rid)
            r.done = True
            self.stats["expired"] += 1

    def _reset_slot(self, s: int, req: Request, degraded: bool) -> None:
        """Admission-time slot bookkeeping of both batching modes: the
        plan choice holds for the request's whole decode, and the slot's
        cache rows reset to the pristine state."""
        self.slot_deg[s] = degraded and self._step_fb is not None
        req.degraded = self.slot_deg[s]
        if req.degraded:
            self.stats["degraded_served"] += 1
        self.cache = self._merge_rows(self.cache, self._cache0, [s])
        self.slot_pos[s] = 0
        self.slot_fed[s] = 0

    def _admit(self, degraded: bool = False):
        """Admit queued requests into free slots: allocation only in
        continuous mode; in bucket mode the whole prompt prefills here,
        one whole-batch call per token, keeping only row s's cache."""
        while (adm := self.table.admit_one()) is not None:
            s, req = adm
            self._reset_slot(s, req, degraded)
            if self.batching == "continuous":
                continue
            others = [r for i, r in enumerate(self.slot_req)
                      if r is not None and i != s]
            cache = self.cache
            step_fn = self._step_fb if self.slot_deg[s] else self._step
            try:
                for t, tok in enumerate(req.prompt):
                    self.ncalls += 1
                    logits, cache = step_fn(cache, self._tokens({s: tok}), t)
            except Exception as e:               # noqa: BLE001 — a
                self._fail_slots([s], e)         # raising prefill must
                continue                         # not wedge the slot
            self.cache = (self._merge_rows(self.cache, cache, [s])
                          if others else cache)
            self.slot_pos[s] = self.slot_fed[s] = len(req.prompt)
            req._next = int(torch.argmax(logits[s, -1]))

    def _feed_round(self, fed: List[int]) -> None:
        """Advance every slot in ``fed`` one token (its next prompt token
        while prefilling, its last sampled token while decoding): one
        whole-batch call per distinct (plan, position) group, keeping
        only that group's rows."""
        live = self.table.active()
        tok_of: Dict[int, int] = {}
        pos_of: Dict[int, int] = {}
        for s in fed:
            req = self.slot_req[s]
            if self.slot_fed[s] < len(req.prompt):
                tok_of[s] = req.prompt[self.slot_fed[s]]
                pos_of[s] = self.slot_fed[s]
            else:
                tok_of[s] = req._next if not req.out else req.out[-1]
                pos_of[s] = self.slot_pos[s]
        toks = self._tokens(tok_of)
        by_grp: Dict[Tuple[bool, int], List[int]] = {}
        for s in fed:
            by_grp.setdefault((self.slot_deg[s], pos_of[s]), []).append(s)
        next_of: Dict[int, int] = {}
        for (deg, pos), group in sorted(by_grp.items()):
            step_fn = self._step_fb if deg else self._step
            try:
                self.ncalls += 1
                logits, stepped = step_fn(self.cache, toks, pos)
                if self._float_retry and not bool(torch.isfinite(
                        logits[group]).all()):
                    # one retry on the float reference of the same
                    # weights: a blown-up BFP step degrades to float
                    # numerics instead of feeding NaN logits to sampling
                    self.stats["float_retries"] += 1
                    self.ncalls += 1
                    logits, stepped = self._float_step_fn()(
                        self.cache, toks, pos)
            except Exception as e:               # noqa: BLE001 — slots
                self._fail_slots(group, e)       # must never leak
                continue
            # one group covering every live slot (steady state): inactive
            # rows are rewritten before any read, so skip the merge
            self.cache = (stepped
                          if len(by_grp) == 1 and len(group) == len(live)
                          else self._merge_rows(self.cache, stepped, group))
            nxt = torch.argmax(logits[:, -1], dim=-1).tolist()
            for s in group:
                next_of[s] = nxt[s]
        for s in fed:
            if s not in next_of:
                continue              # group failed; slot already freed
            req = self.slot_req[s]
            if self.slot_fed[s] < len(req.prompt):
                self.slot_fed[s] += 1
                self.slot_pos[s] = self.slot_fed[s]
                if self.slot_fed[s] == len(req.prompt):
                    req._next = next_of[s]
            else:
                req.out.append(next_of[s])
                self.slot_pos[s] += 1
                if len(req.out) >= req.max_new:
                    req.done = True
                    self.stats["completed"] += 1
                    self.table.free(s)

    def step(self) -> int:
        """One engine iteration; returns the number of requests still
        queued or in flight AFTER the step (0 == drained), so
        ``while eng.step(): ...`` serves to completion.  Order: the
        controller observes the pre-admission queue depth, expiry, then
        admission (onto the fallback plan while degraded), then every
        active slot advances: decoders one token, prefilling slots up to
        ``prefill_chunk`` prompt tokens (plus their first decode when
        the prompt completes within the chunk)."""
        degraded = False
        if self.controller is not None:
            state = self.controller.observe(len(self.queue))
            degraded = state == DegradeController.DEGRADED
        self._expire()
        self._admit(degraded)
        active = self.table.active()
        if not active:
            return self.table.pending()
        chunk = self.prefill_chunk
        budget: Dict[int, int] = {}
        for s in active:
            rem = len(self.slot_req[s].prompt) - self.slot_fed[s]
            if rem > 0:
                n = rem if chunk is None else min(rem, chunk)
                budget[s] = n + (1 if n == rem else 0)
            else:
                budget[s] = 1
        while True:
            fed = [s for s in self.table.active() if budget.get(s, 0) > 0]
            if not fed:
                break
            self._feed_round(fed)
            for s in fed:
                budget[s] -= 1
        return self.table.pending()

    def run(self) -> List[Request]:
        """Serve to completion; returns the requests in flight or queued
        when called."""
        all_reqs = [r for r in self.slot_req if r is not None] + \
            list(self.queue)
        while self.table.pending():
            self.step()
        return all_reqs
