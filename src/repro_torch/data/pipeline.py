"""Deterministic synthetic data pipelines (counterpart of
``repro.data.pipeline``; ``image_batch`` only — the LM stream and
``host_shard`` arrive with the LM stack).

``step -> batch`` is a pure function of (seed, step): any host can
recompute any batch, with no loader state to checkpoint.  The port draws
from a ``torch.Generator`` and cannot replay ``jax.random``'s streams, so
the same seed gives another batch than ``repro``'s: tests that compare
the two packages feed both the same numpy batch.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch._device import DeviceLike, resolve_device

__all__ = ["image_batch"]


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
