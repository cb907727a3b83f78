"""LM training step (counterpart of ``repro.train.step``): loss, gradient
accumulation, optimizer, BFP.

``make_train_step(cfg, ...)`` returns ``(state, batch) -> (state,
metrics)``.  Gradients come from ``grad.value_and_grad``, as in
``train.cnn``: a zero gradient wherever ``jax.grad`` gives zeros (the
empty ``periods`` leaves of a short hybrid, the experts when the policy
differentiates through the quantizer).  BFP GEMMs take
``repro_torch.grad``'s autograd route: on the kernels for the kernel
backend, both backward GEMMs under the grad-path policies.
Microbatches run as a Python loop in place of ``repro``'s ``lax.scan``.
PyTorch runs eagerly: there is nothing to jit.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch._tree import is_float, tree_map
from repro_torch.configs.base import LMConfig
from repro_torch.engine.policy_map import PolicyLike
from repro_torch.grad import value_and_grad
from repro_torch.models.lm import model as Mdl
from repro_torch.optim import optimizers as opt

__all__ = ["TrainState", "make_train_step", "lm_loss", "init_state"]


class TrainState(NamedTuple):
    params: Any
    opt_state: opt.OptState
    step: torch.Tensor           #: int32, 0-d


def lm_loss(params, cfg: LMConfig, tokens, targets, policy=None,
            enc_feats=None, aux_weight: float = 0.01,
            z_weight: float = 1e-4
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy + MoE aux + z-loss."""
    logits, aux = Mdl.forward(params, cfg, tokens, enc_feats=enc_feats,
                              policy=policy)
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    # the gather has the one-hot contraction's value and gradient for
    # finite logits; its [B, S, 1] result is reduced as it is (DTensor
    # masks a vocab-sharded gather's partial result by the gather's own
    # shape, which a select of the last dim would break)
    ll = torch.gather(logits, -1, targets.long()[..., None])
    nll = torch.mean(logz[..., None] - ll)
    zloss = torch.mean(torch.square(logz))
    loss = nll + aux_weight * aux + z_weight * zloss
    return loss, {"nll": nll, "aux": aux, "zloss": zloss}


def init_state(cfg: LMConfig, gen: torch.Generator, *,
               device: DeviceLike = "cuda") -> TrainState:
    """Seeded params (``models.lm.model.init_params``), AdamW state and
    step 0 on ``device``."""
    dev = resolve_device(device)
    params = Mdl.init_params(cfg, gen, device=dev)
    return TrainState(params=params, opt_state=opt.adamw_init(params),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def make_train_step(
    cfg: LMConfig,
    lr_schedule: Callable = None,
    grad_accum: int = 1,
    max_grad_norm: float = 1.0,
    policy: PolicyLike = None,
    weight_decay: float = 0.1,
    grad_transform: Optional[Callable[[Any], Any]] = None,
) -> Callable[[TrainState, Tuple[torch.Tensor, torch.Tensor]],
              Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Build the train step.

    policy: None / BFPPolicy / PolicyMap / bound Plan: BFP-QAT with a
    uniform or per-layer datapath assignment.
    grad_transform: optional hook applied to the accumulated grads BEFORE
    the optimizer (BFP gradient compression, ``dist.compress``).
    """
    lr_schedule = lr_schedule or opt.constant_schedule(3e-4)

    def loss_fn(params, tokens, targets):
        return lm_loss(params, cfg, tokens, targets, policy=policy)

    def train_step(state: TrainState, batch):
        tokens, targets = batch
        if grad_accum > 1:
            mb = tokens.shape[0] // grad_accum
            gsum = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device)
                if is_float(p) else p, state.params)
            lsum = 0.0
            for i in range(grad_accum):
                rows = slice(i * mb, (i + 1) * mb)
                (loss, _), g = value_and_grad(
                    lambda p: loss_fn(p, tokens[rows], targets[rows]),
                    state.params)
                gsum = tree_map(lambda a, b: a + b if is_float(a) else a,
                                gsum, g)
                lsum = lsum + loss
            grads = tree_map(lambda g: g / grad_accum if is_float(g)
                             else g, gsum)
            loss = lsum / grad_accum
            metrics: Dict[str, torch.Tensor] = {}
        else:
            (loss, metrics), grads = value_and_grad(
                lambda p: loss_fn(p, tokens, targets), state.params)

        with torch.no_grad():
            if grad_transform is not None:
                grads = grad_transform(grads)
            grads, gnorm = opt.clip_by_global_norm(grads, max_grad_norm)
            lr = lr_schedule(state.step)
            params, opt_state = opt.adamw_update(
                grads, state.opt_state, state.params, lr,
                weight_decay=weight_decay)
        new_state = TrainState(params=params, opt_state=opt_state,
                               step=state.step + 1)
        out = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        out.update(metrics)
        return new_state, out

    return train_step
