"""CNN zoo of the port (counterpart of ``repro.models.cnn``).

``MODELS`` registers the ported models behind a uniform :class:`CnnSpec`;
this slice carries VGG16, the paper's main analysis model.  ResNet-18/50,
GoogLeNet and the small models follow in later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch._device import DeviceLike
from repro_torch.models.cnn import vgg as _vgg

__all__ = ["CnnSpec", "MODELS", "head_logits"]


def head_logits(out):
    """Classifier logits from an ``apply()`` output (head 0 of a tuple)."""
    return out[0] if isinstance(out, tuple) else out


@dataclasses.dataclass(frozen=True)
class CnnSpec:
    """One registered CNN: how to build it and what it eats."""

    name: str
    init: Callable[..., Any]   #: init(gen, *, reduced, device) -> params
    apply: Callable[..., Any]  #: apply(params, x, policy) -> logits
    full_hw: int               #: full-scale input H == W
    reduced_hw: int            #: test-sized input H == W
    in_ch: int = 3

    def input_shape(self, *, reduced: bool = True) -> Tuple[int, int, int]:
        hw = self.reduced_hw if reduced else self.full_hw
        return (hw, hw, self.in_ch)


def _vgg16_init(gen: torch.Generator, *, reduced: bool = True,
                num_classes: int = 10, device: DeviceLike = "cuda"):
    if reduced:
        return _vgg.init(gen, num_classes, width_mult=0.125, input_hw=32,
                         fc_dim=64, device=device)
    return _vgg.init(gen, 1000, device=device)


MODELS: Dict[str, CnnSpec] = {
    "vgg16": CnnSpec("vgg16", _vgg16_init, _vgg.apply, 224, 32),
}
