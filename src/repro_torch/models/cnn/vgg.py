"""VGG-16 (Simonyan & Zisserman 2014) — the paper's main analysis vehicle
(counterpart of ``repro.models.cnn.vgg``).

``width_mult``/``input_hw``/``fc_dim`` build a reduced config of the same
family for tests.  Layer paths are the plan names ("conv1_1" ... "fc8"),
so PolicyMap rules and bound plans address the same sites as in
``repro``.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch._device import DeviceLike
from repro_torch.engine import PolicyLike
from repro_torch.models.cnn import layers as L

__all__ = ["VGG16_CONV_PLAN", "init", "apply", "conv_names"]

# ("conv_name", out_ch): stride-1 SAME 3x3 conv + ReLU; ("pool", 0): 2x2
# max pool.  fc6/fc7 (+ReLU) and fc8 follow the NHWC flatten.
VGG16_CONV_PLAN: List[Tuple[str, int]] = [
    ("conv1_1", 64), ("conv1_2", 64), ("pool", 0),
    ("conv2_1", 128), ("conv2_2", 128), ("pool", 0),
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), ("pool", 0),
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), ("pool", 0),
    ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512), ("pool", 0),
]


def init(gen: torch.Generator, num_classes: int = 1000, in_ch: int = 3,
         width_mult: float = 1.0, input_hw: int = 224, fc_dim: int = 4096,
         device: DeviceLike = "cuda"):
    """He-initialized VGG16 params drawn from ``gen``, placed on
    ``device``."""
    params = {}
    ch, hw = in_ch, input_hw
    for name, out in VGG16_CONV_PLAN:
        if name == "pool":
            hw //= 2
            continue
        out = max(8, int(out * width_mult))
        params[name] = L.conv2d_init(gen, ch, out, 3, 3, device)
        ch = out
    params["fc6"] = L.dense_init(gen, ch * hw * hw, fc_dim, device)
    params["fc7"] = L.dense_init(gen, fc_dim, fc_dim, device)
    params["fc8"] = L.dense_init(gen, fc_dim, num_classes, device)
    return params


def apply(params, x: torch.Tensor, policy: PolicyLike = None) -> torch.Tensor:
    """NHWC images -> logits; ``policy`` may be a bound Plan."""
    for name, _ in VGG16_CONV_PLAN:
        if name == "pool":
            x = L.max_pool(x)
        else:
            x = L.relu(L.conv2d(params[name], x, 1, "SAME", policy,
                                path=name))
    x = x.reshape(x.shape[0], -1)           # NHWC flatten, as in repro
    x = L.relu(L.dense(params["fc6"], x, policy, path="fc6"))
    x = L.relu(L.dense(params["fc7"], x, policy, path="fc7"))
    return L.dense(params["fc8"], x, policy, path="fc8")


def conv_names() -> List[str]:
    return [n for n, _ in VGG16_CONV_PLAN if n != "pool"]
