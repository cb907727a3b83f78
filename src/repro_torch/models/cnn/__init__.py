"""CNN zoo of the port (counterpart of ``repro.models.cnn``).

``MODELS`` registers the paper's four test models (VGG16, ResNet-18/50,
GoogLeNet) and the two small ones behind a uniform :class:`CnnSpec`
(init / apply / input geometry); ``reduced=True`` builds the test-sized
configuration of the same family, as ``repro``'s registry does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch._device import DeviceLike
from repro_torch.models.cnn import googlenet as _googlenet
from repro_torch.models.cnn import resnet as _resnet
from repro_torch.models.cnn import small as _small
from repro_torch.models.cnn import vgg as _vgg

__all__ = ["CnnSpec", "MODELS", "head_logits"]


def head_logits(out):
    """Classifier logits from an ``apply()`` output: head 0 of a tuple
    (GoogLeNet's loss3), else the logits themselves."""
    return out[0] if isinstance(out, tuple) else out


@dataclasses.dataclass(frozen=True)
class CnnSpec:
    """One registered CNN: how to build it and what it eats."""

    name: str
    init: Callable[..., Any]   #: init(gen, *, reduced, device) -> params
    apply: Callable[..., Any]  #: apply(params, x, policy) -> logits/heads
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


def _resnet18_init(gen: torch.Generator, *, reduced: bool = True,
                   num_classes: int = 10, device: DeviceLike = "cuda"):
    if reduced:
        return _resnet.init(gen, 18, num_classes, width_mult=0.25,
                            stage_depths=(1, 1, 1, 1), device=device)
    return _resnet.init(gen, 18, 1000, device=device)


def _resnet50_init(gen: torch.Generator, *, reduced: bool = True,
                   num_classes: int = 10, device: DeviceLike = "cuda"):
    if reduced:
        return _resnet.init(gen, 50, num_classes, width_mult=0.125,
                            stage_depths=(1, 1, 1, 1), device=device)
    return _resnet.init(gen, 50, 1000, device=device)


def _googlenet_init(gen: torch.Generator, *, reduced: bool = True,
                    num_classes: int = 10, device: DeviceLike = "cuda"):
    if reduced:
        return _googlenet.init(gen, num_classes, width_mult=0.125,
                               device=device)
    return _googlenet.init(gen, 1000, device=device)


def _lenet_init(gen: torch.Generator, *, reduced: bool = True,
                num_classes: int = 10, device: DeviceLike = "cuda"):
    return _small.lenet_init(gen, num_classes, device=device)


def _cifarnet_init(gen: torch.Generator, *, reduced: bool = True,
                   num_classes: int = 10, device: DeviceLike = "cuda"):
    return _small.cifarnet_init(gen, num_classes, device=device)


MODELS: Dict[str, CnnSpec] = {
    "vgg16": CnnSpec("vgg16", _vgg16_init, _vgg.apply, 224, 32),
    "resnet18": CnnSpec("resnet18", _resnet18_init, _resnet.apply,
                        224, 32),
    "resnet50": CnnSpec("resnet50", _resnet50_init, _resnet.apply,
                        224, 32),
    "googlenet": CnnSpec("googlenet", _googlenet_init, _googlenet.apply,
                         224, 64),
    "lenet": CnnSpec("lenet", _lenet_init, _small.lenet_apply,
                     28, 28, in_ch=1),
    "cifarnet": CnnSpec("cifarnet", _cifarnet_init, _small.cifarnet_apply,
                        32, 32),
}
