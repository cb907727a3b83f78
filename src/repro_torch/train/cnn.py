"""Data-parallel BFP CNN training with compressed gradient exchange
(counterpart of ``repro.train.cnn``).

Forward and backward GEMMs both run on the BFP engine datapath
(``repro_torch.grad``'s autograd functions under the grad-path
policies: on the kernels for the cuda backend), and the data-parallel
gradient exchange is block-formatted over the packed wire format with
error feedback (``repro_torch.dist.compress``).

W logical workers on one device: the global batch splits into W
microbatches, a Python loop over workers takes the place of ``repro``'s
``jax.vmap(value_and_grad)``, each worker compresses ``g + residual``
through the BFP wire (carrying its own residual), and the decompressed
contributions are averaged: an all-reduce over the compressed wire.
Two interchangeable exchange routes, bit-exact to each other:

  * the in-graph model (``dist.compress.make_compressor``): the
    training step;
  * the real packed bytes (``dist.compress.packed_allreduce``): every
    worker contribution serialized through the CRC-verified
    :class:`~repro_torch.core.packed.PackedBFP` container, with the
    measured wire bytes.

``train_cnn`` drives steps, measures gradient NSR on the live backward
datapath (``repro_torch.grad.measure_gradient_nsr``) on a schedule,
evaluates accuracy, and optionally round-trips the whole train state,
error-feedback residuals included, through ``checkpoint.store``.
PyTorch runs eagerly: ``train_cnn(jit=)`` is accepted and ignored.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import _tree
from repro_torch._device import DeviceLike, resolve_device
from repro_torch._tree import tree_map
from repro_torch.data.pipeline import image_batch
from repro_torch.dist import compress as DC
from repro_torch.engine.policy_map import PolicyLike
from repro_torch.grad import value_and_grad
from repro_torch.grad.nsr import GradNSRRecord, measure_gradient_nsr
from repro_torch.grad.vjp import _is_float
from repro_torch.models.cnn import MODELS, head_logits
from repro_torch.optim import optimizers as opt

__all__ = ["CnnTrainConfig", "CnnTrainState", "init_state", "data_batch",
           "cnn_loss", "make_cnn_train_step", "packed_exchange_step",
           "evaluate", "train_cnn"]


@dataclasses.dataclass(frozen=True)
class CnnTrainConfig:
    """Static training configuration (hashable)."""

    model: str = "cifarnet"
    workers: int = 2             #: logical data-parallel workers
    batch: int = 64              #: GLOBAL batch (split across workers)
    num_classes: int = 10
    lr: float = 2e-3
    weight_decay: float = 1e-4
    max_grad_norm: float = 1.0
    policy: PolicyLike = None    #: forward+backward datapath policy
    grad_bits: Optional[int] = None   #: wire mantissa bits (None = float
                                      #: exchange, no compression)
    wire_block: int = DC.WIRE_BLOCK
    seed: int = 0

    def __post_init__(self):
        if self.batch % self.workers:
            raise ValueError(f"batch={self.batch} must split across "
                             f"workers={self.workers}")
        if self.grad_bits is not None:
            DC.validate_wire_block(self.wire_block)


class CnnTrainState(NamedTuple):
    params: Any
    opt_state: opt.OptState
    residual: Any        #: per-worker EF residuals, leaves [W, ...]
    step: torch.Tensor


def _spec(cfg: CnnTrainConfig):
    return MODELS[cfg.model]


def init_state(cfg: CnnTrainConfig, gen: Optional[torch.Generator] = None,
               *, device: DeviceLike = "cuda") -> CnnTrainState:
    """Fresh reduced-model params (``repro``'s training configuration),
    AdamW state and zero per-worker residuals.  A state of any width
    built the same way (``CnnTrainState(params, opt.adamw_init(params),
    zero residuals, step)``) trains through the same step functions."""
    gen = torch.Generator().manual_seed(cfg.seed) if gen is None else gen
    dev = resolve_device(device)
    params = _spec(cfg).init(gen, reduced=True,
                             num_classes=cfg.num_classes, device=dev)
    residual = tree_map(
        lambda p: torch.zeros((cfg.workers,) + tuple(np.shape(p)),
                              dtype=torch.float32, device=dev), params)
    return CnnTrainState(params=params, opt_state=opt.adamw_init(params),
                         residual=residual,
                         step=torch.zeros((), dtype=torch.int32, device=dev))


def data_batch(cfg: CnnTrainConfig, step: int, templates=None, *,
               device: DeviceLike = "cuda"):
    """Deterministic synthetic batch for ``step`` (templates persist)."""
    hw, _, ch = _spec(cfg).input_shape(reduced=True)
    if templates is None:
        _, _, templates = image_batch(
            torch.Generator().manual_seed(1234 + cfg.seed), cfg.num_classes,
            2, hw, ch, device="cpu")
    gen = torch.Generator().manual_seed((cfg.seed << 32) + step)
    x, y, _ = image_batch(gen, cfg.num_classes, cfg.batch, hw, ch,
                          templates, device=device)
    return x, y, templates


def cnn_loss(params, apply_fn, x, y, policy: PolicyLike,
             num_classes: int) -> torch.Tensor:
    logits = head_logits(apply_fn(params, x, policy))
    onehot = F.one_hot(y.long(), num_classes).float()
    logp = F.log_softmax(logits.float(), dim=-1)
    return -torch.mean(torch.sum(logp * onehot, dim=-1))


def _value_and_grad(cfg: CnnTrainConfig, apply_fn, params, x, y):
    """(loss, grads) of one batch (``grad.value_and_grad``)."""
    (loss, _), grads = value_and_grad(lambda p: (cnn_loss(
        p, apply_fn, x, y, cfg.policy, cfg.num_classes), {}), params)
    return loss, grads


def _worker_grads(cfg: CnnTrainConfig, apply_fn, params, x, y):
    """Per-worker (losses [W], grads with float leaves [W, ...])."""
    mb = cfg.batch // cfg.workers
    outs = [_value_and_grad(cfg, apply_fn, params, x[i * mb:(i + 1) * mb],
                            y[i * mb:(i + 1) * mb])
            for i in range(cfg.workers)]
    grads = tree_map(lambda *g: torch.stack(g) if _is_float(g[0]) else g[0],
                     *[g for _, g in outs])
    return torch.stack([loss for loss, _ in outs]), grads


def _apply_update(cfg: CnnTrainConfig, state: CnnTrainState, mean_g,
                  residual, losses) -> Tuple[CnnTrainState, Dict]:
    g, gnorm = opt.clip_by_global_norm(mean_g, cfg.max_grad_norm)
    params, opt_state = opt.adamw_update(
        g, state.opt_state, state.params, cfg.lr,
        weight_decay=cfg.weight_decay)
    new = CnnTrainState(params, opt_state, residual, state.step + 1)
    return new, {"loss": torch.mean(losses), "grad_norm": gnorm}


def _per_worker(transform, grads, residual):
    """``transform`` (a leafwise ``(grads, residual) -> (q, r')``) on each
    worker's slice of the stacked trees, restacked: ``repro``'s
    ``jax.vmap(transform)``."""
    workers = next(r.shape[0] for r in _tree.flatten(residual)[0])
    outs = [transform(tree_map(lambda t: t[i] if _is_float(t) else t,
                               grads),
                      tree_map(lambda t: t[i], residual))
            for i in range(workers)]
    return tuple(tree_map(lambda *t: torch.stack(t) if _is_float(t[0])
                          else t[0], *[o[j] for o in outs])
                 for j in (0, 1))


def _mean(t):
    return torch.mean(t, dim=0) if _is_float(t) else t


def make_cnn_train_step(cfg: CnnTrainConfig, apply_fn=None):
    """``(state, (x, y)) -> (state, metrics)``.

    The gradient exchange uses the in-graph wire model
    (``dist.compress.make_compressor``) per worker, bit-exact to
    :func:`packed_exchange_step`, which moves the actual bytes.
    """
    apply_fn = apply_fn or _spec(cfg).apply
    if cfg.grad_bits is not None:
        _, transform = DC.make_compressor(cfg.grad_bits, cfg.wire_block)

    def step_fn(state: CnnTrainState, batch):
        x, y = batch
        losses, grads = _worker_grads(cfg, apply_fn, state.params, x, y)
        with torch.no_grad():
            if cfg.grad_bits is not None:
                q, residual = _per_worker(transform, grads, state.residual)
            else:
                q, residual = grads, state.residual
            return _apply_update(cfg, state, tree_map(_mean, q), residual,
                                 losses)

    return step_fn


def packed_exchange_step(cfg: CnnTrainConfig, state: CnnTrainState,
                         batch, apply_fn=None
                         ) -> Tuple[CnnTrainState, Dict]:
    """One step exchanging gradients over the REAL packed wire: the
    arithmetic of :func:`make_cnn_train_step` with the compression
    routed through :func:`dist.compress.packed_allreduce` (every worker
    contribution serialized, CRC-verified and counted).
    ``metrics["wire_bytes"]`` is the measured exchange traffic."""
    if cfg.grad_bits is None:
        raise ValueError("packed exchange needs grad_bits (a wire format)")
    apply_fn = apply_fn or _spec(cfg).apply
    x, y = batch
    losses, grads = _worker_grads(cfg, apply_fn, state.params, x, y)
    with torch.no_grad():
        mean_g, residual, n_bytes = DC.packed_allreduce(
            grads, state.residual, cfg.grad_bits, cfg.wire_block)
        new, metrics = _apply_update(cfg, state, mean_g, residual, losses)
    metrics["wire_bytes"] = n_bytes
    return new, metrics


def _params_device(params) -> torch.device:
    return next(p.device for p in _tree.flatten(params)[0]
                if isinstance(p, torch.Tensor))


def evaluate(cfg: CnnTrainConfig, params, templates, batch: int = 256
             ) -> float:
    """Top-1 accuracy on a held-out deterministic eval batch (on the
    params' device)."""
    spec = _spec(cfg)
    hw, _, ch = spec.input_shape(reduced=True)
    x, y, _ = image_batch(torch.Generator().manual_seed(999),
                          cfg.num_classes, batch, hw, ch, templates,
                          device=_params_device(params))
    with torch.no_grad():
        logits = head_logits(spec.apply(params, x, cfg.policy))
    return float(torch.mean((torch.argmax(logits, -1) == y).float()))


def train_cnn(cfg: CnnTrainConfig, steps: int = 60, *,
              eval_every: int = 0, eval_batch: int = 256,
              measure_nsr_every: int = 0,
              packed_wire_steps: int = 0,
              ckpt_dir: Optional[str] = None,
              jit: bool = True, device: DeviceLike = "cuda"
              ) -> Dict[str, Any]:
    """Train ``cfg.model`` for ``steps`` and report curves + wire bytes.

    Args:
      eval_every: evaluate accuracy every N steps (and always at the
        end); 0 = final only.
      measure_nsr_every: every N steps, additionally run ONE tapped
        gradient computation on the current batch (the state does not
        advance) and record per-backward-GEMM measured NSR vs bound.
      packed_wire_steps: run the FIRST N steps through the real packed
        wire (:func:`packed_exchange_step`) instead of the in-graph model
        (the two routes are bit-exact).
      ckpt_dir: save the final state (residuals included) there and
        verify a restore round trip.
      jit: accepted for ``repro``'s signature; PyTorch runs eagerly.
      device: where the state and batches live ("cuda" unless asked).

    Returns a dict with ``history`` (per-step loss/grad_norm),
    ``accuracy``, ``eval_curve``, ``nsr_records``, ``wire_bytes`` (sum
    over packed steps, plus an analytic per-step report), ``state``.
    """
    dev = resolve_device(device)
    state = init_state(cfg, device=dev)
    _, _, templates = data_batch(cfg, 0, device=dev)
    step_fn = make_cnn_train_step(cfg)

    history: List[Dict[str, float]] = []
    eval_curve: List[Tuple[int, float]] = []
    nsr_records: List[GradNSRRecord] = []
    wire_bytes = 0

    for i in range(steps):
        x, y, _ = data_batch(cfg, i, templates, device=dev)

        if measure_nsr_every and i % measure_nsr_every == 0:
            params = state.params
            nsr_records.extend(measure_gradient_nsr(
                lambda: _value_and_grad(cfg, _spec(cfg).apply, params, x,
                                        y)))

        if cfg.grad_bits is not None and i < packed_wire_steps:
            state, metrics = packed_exchange_step(cfg, state, (x, y))
            wire_bytes += metrics.pop("wire_bytes")
        else:
            state, metrics = step_fn(state, (x, y))
        history.append({k: float(v) for k, v in metrics.items()})

        if eval_every and (i + 1) % eval_every == 0 and i + 1 < steps:
            eval_curve.append((i + 1, evaluate(cfg, state.params, templates,
                                               eval_batch)))

    acc = evaluate(cfg, state.params, templates, eval_batch)
    eval_curve.append((steps, acc))

    if ckpt_dir is not None:
        from repro_torch.checkpoint import store
        store.save(ckpt_dir, int(state.step), state)
        restored, rstep = store.restore(ckpt_dir, state, device=dev)
        if rstep != int(state.step):
            raise RuntimeError(f"checkpoint round trip restored step "
                               f"{rstep}, saved {int(state.step)}")
        state = restored

    wire = None
    if cfg.grad_bits is not None:
        # analytic per-step exchange bytes (all workers) + float baseline
        rep = DC.wire_report(state.params, cfg.grad_bits, cfg.wire_block)
        wire = {"measured_bytes": wire_bytes,
                "packed_steps": min(packed_wire_steps, steps),
                "per_step_bytes": rep["wire_bytes"] * cfg.workers,
                "float_per_step_bytes": rep["float_bytes"] * cfg.workers,
                "ratio": rep["ratio"]}

    return {"history": history, "accuracy": acc, "eval_curve": eval_curve,
            "nsr_records": nsr_records, "wire_bytes": wire,
            "state": state}
