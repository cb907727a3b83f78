"""Deterministic synthetic data pipelines (counterpart of
``repro.data.pipeline``).

Fault-tolerance contract: ``step -> batch`` is a pure function of (seed,
step, shard), so any host can recompute any shard after a failure or an
elastic re-shard, with no loader state to checkpoint.  The port draws
from a ``torch.Generator`` and cannot replay ``jax.random``'s streams, so
the same seed gives another batch than ``repro``'s: tests that compare
the two packages feed both the same numpy batch, or drive the LM
stream's recurrence (:func:`lm_tokens`) with ``repro``'s own draws.

LM stream: a learnable second-order pattern (each token depends on the
two before it) with sparse noise, so a ~100M model's loss visibly drops
within a few hundred steps.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device

__all__ = ["LMBatchSpec", "lm_batch", "lm_tokens", "image_batch",
           "host_shard", "step_generator"]


def step_generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator seeded from (``seed``, ``step``).  A CPU
    ``torch.Generator`` keeps only the low 32 bits of its seed, so the
    pair is mixed into them by ``np.random.SeedSequence``: every seed
    and every step gives its own stream."""
    return torch.Generator().manual_seed(int(
        np.random.SeedSequence([seed, step]).generate_state(1)[0]))


@dataclasses.dataclass(frozen=True)
class LMBatchSpec:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    pattern_vocab: int = 512   # active band of the vocab (learnability)


def lm_tokens(t0: torch.Tensor, noise: torch.Tensor,
              noise_tok: torch.Tensor, p: int) -> torch.Tensor:
    """The LM stream's recurrence, a pure function of its draws:
    ``t_{i+1} = (5 t_i + 3 t_{i-1} + 7) mod p``, replaced by
    ``noise_tok[:, i]`` where ``noise[:, i]``.  t0: [B, 2] seed tokens,
    noise: [B, S] bool, noise_tok: [B, S] -> tokens [B, S] int32."""
    prev2, prev1 = t0[:, 0].long(), t0[:, 1].long()
    noise_tok = noise_tok.long()
    out = []
    for i in range(noise.shape[1]):
        nxt = torch.where(noise[:, i], noise_tok[:, i],
                          (5 * prev1 + 3 * prev2 + 7) % p)
        out.append(nxt)
        prev2, prev1 = prev1, nxt
    return torch.stack(out, dim=1).to(torch.int32)


def lm_batch(spec: LMBatchSpec, step: int, *, device: DeviceLike = "cuda"
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deterministic (tokens, targets) [B, S] int32 for a global step.

    Drawn on the host from a generator seeded from (``spec.seed``,
    step):
    the two seed tokens per row, the noise mask (5%) and the noise
    tokens, in that order, then :func:`lm_tokens`; ``targets`` is tokens
    rolled by one (the last target wraps round, as in ``repro``)."""
    dev = resolve_device(device)
    p = min(spec.pattern_vocab, spec.vocab_size)
    gen = step_generator(spec.seed, step)
    b, s = spec.global_batch, spec.seq_len
    t0 = torch.randint(0, p, (b, 2), generator=gen)
    noise = torch.rand((b, s), generator=gen) < 0.05
    noise_tok = torch.randint(0, p, (b, s), generator=gen)
    tokens = lm_tokens(t0, noise, noise_tok, p)
    targets = torch.roll(tokens, -1, dims=1)
    return tokens.to(dev), targets.to(dev)


def image_batch(gen: torch.Generator, num_classes: int, batch: int, hw: int,
                ch: int, templates: Optional[torch.Tensor] = None, *,
                device: DeviceLike = "cuda"
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Class-template images + noise (the in-repo 'mnist' / 'cifar10').

    Returns (images [B, H, W, C] and labels [B] on ``device``, templates
    [num_classes, H, W, C] on the host): pass templates back in for a
    consistent dataset across batches.  Drawn on the host from ``gen``
    (a CPU generator): templates (when not given), labels, shifts, noise.
    """
    dev = resolve_device(device)
    if templates is None:
        t = torch.randn((num_classes, hw, hw, ch), generator=gen)
        # smooth the templates a little (structured, image-like)
        templates = (t + torch.roll(t, 1, 1) + torch.roll(t, -1, 1)
                     + torch.roll(t, 1, 2) + torch.roll(t, -1, 2)) / 5.0
    templates = templates.cpu()
    labels = torch.randint(0, num_classes, (batch,), generator=gen)
    shift = torch.randint(-2, 3, (batch, 2), generator=gen).tolist()
    imgs = torch.stack([torch.roll(templates[c], tuple(s), dims=(0, 1))
                        for c, s in zip(labels.tolist(), shift)])
    imgs = imgs + 0.35 * torch.randn(imgs.shape, generator=gen)
    return imgs.to(dev), labels.to(dev), templates


def host_shard(global_batch: int, process_index: Optional[int] = None,
               process_count: Optional[int] = None) -> slice:
    """Which rows of the global batch this process materializes: rank
    and world size of ``torch.distributed`` when it is initialised, 0
    and 1 otherwise."""
    dist = torch.distributed
    up = dist.is_available() and dist.is_initialized()
    pi = (dist.get_rank() if up else 0) if process_index is None \
        else process_index
    pc = (dist.get_world_size() if up else 1) if process_count is None \
        else process_count
    per = global_batch // pc
    return slice(pi * per, (pi + 1) * per)
