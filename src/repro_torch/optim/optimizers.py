"""Optimizers (init/update pairs over parameter trees) and learning-rate
schedules (counterpart of ``repro.optim.optimizers``).

Trees are walked in ``repro``'s leaf order (``repro_torch._tree``), so an
:class:`OptState` checkpoints leaf for leaf like ``repro``'s.  Non-float
leaves (int metadata) pass through untouched.  Includes the WSD
(warmup-stable-decay) schedule that minicpm-2b trains with
(arXiv:2404.06395), cosine, and linear warmup.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch import _tree
from repro_torch._tree import is_float, tree_map

__all__ = ["adamw_init", "adamw_update", "sgd_init", "sgd_update",
           "clip_by_global_norm", "global_norm",
           "cosine_schedule", "wsd_schedule", "constant_schedule",
           "OptState"]


class OptState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


def _device(tree) -> torch.device:
    """The device of the tree's first tensor leaf (the CPU if none)."""
    for leaf in _tree.flatten(tree)[0]:
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float()))
              for x in _tree.flatten(tree)[0] if is_float(x)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale if is_float(g) else g,
                    grads), norm


def adamw_init(params) -> OptState:
    def zeros(p):
        return tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32)
                        if is_float(x) else x, p)
    return OptState(step=torch.zeros((), dtype=torch.int32,
                                     device=_device(params)),
                    mu=zeros(params), nu=zeros(params))


def adamw_update(grads, state: OptState, params, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1) -> Tuple[Any, OptState]:
    # non-float leaves (int metadata) pass through untouched
    step = state.step + 1
    t = step.float()
    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float()
                  if is_float(g) else m, state.mu, grads)
    nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float())
                  if is_float(g) else v, state.nu, grads)
    bc1 = 1 - b1 ** t
    bc2 = 1 - b2 ** t

    def upd(p, m, v):
        if not is_float(p):
            return p
        mhat = m / bc1
        vhat = v / bc2
        return (p.float() - lr * (mhat / (torch.sqrt(vhat) + eps)
                                  + weight_decay * p.float())).to(p.dtype)

    new_params = tree_map(upd, params, mu, nu)
    return new_params, OptState(step=step, mu=mu, nu=nu)


def sgd_init(params) -> OptState:
    mom = tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                   params)
    return OptState(step=torch.zeros((), dtype=torch.int32,
                                     device=_device(params)),
                    mu=mom, nu=None)


def sgd_update(grads, state: OptState, params, lr, momentum: float = 0.9
               ) -> Tuple[Any, OptState]:
    mu = tree_map(lambda m, g: momentum * m + g.float(), state.mu, grads)
    new_params = tree_map(
        lambda p, m: (p.float() - lr * m).to(p.dtype), params, mu)
    return new_params, OptState(step=state.step + 1, mu=mu, nu=None)


# ---------------------------------------------------------------------------
# Schedules: step -> lr
# ---------------------------------------------------------------------------

def constant_schedule(lr: float) -> Callable:
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def cosine_schedule(peak: float, warmup: int, total: int,
                    floor_frac: float = 0.1) -> Callable:
    def f(step):
        step = torch.as_tensor(step).float()
        warm = peak * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = peak * (floor_frac + (1 - floor_frac)
                      * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return f


def wsd_schedule(peak: float, warmup: int, stable: int, decay: int,
                 floor_frac: float = 0.01) -> Callable:
    """Warmup-Stable-Decay (minicpm): linear warmup, flat plateau, then a
    short exponential-ish (here linear-log) decay to the floor."""
    def f(step):
        step = torch.as_tensor(step).float()
        warm = peak * step / max(warmup, 1)
        prog = torch.clamp((step - warmup - stable) / max(decay, 1), 0.0,
                           1.0)
        dec = peak * torch.exp(math.log(floor_frac) * prog)
        return torch.where(step < warmup, warm,
                           torch.where(step < warmup + stable,
                                       torch.full_like(step, peak), dec))
    return f
