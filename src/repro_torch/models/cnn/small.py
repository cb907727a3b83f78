"""Small CNNs — the paper's "mnist" and "cifar10" columns (counterpart of
``repro.models.cnn.small``): LeNet-5-style for 28x28x1 and CIFAR-quick
for 32x32x3.  Layer paths ("c1", "c2", ..., "fc1", "fc2") feed PolicyMap
per-layer rules; convs run through ``engine.conv2d``."""
from __future__ import annotations

import torch

from repro_torch._device import DeviceLike
from repro_torch.engine import PolicyLike
from repro_torch.models.cnn import layers as L

__all__ = ["lenet_init", "lenet_apply", "cifarnet_init", "cifarnet_apply"]


def lenet_init(gen: torch.Generator, num_classes: int = 10, in_ch: int = 1,
               device: DeviceLike = "cuda"):
    return {"c1": L.conv2d_init(gen, in_ch, 16, 5, 5, device),
            "c2": L.conv2d_init(gen, 16, 32, 5, 5, device),
            "fc1": L.dense_init(gen, 32 * 7 * 7, 128, device),
            "fc2": L.dense_init(gen, 128, num_classes, device)}


def lenet_apply(params, x: torch.Tensor, policy: PolicyLike = None):
    x = L.relu(L.conv2d(params["c1"], x, 1, "SAME", policy, path="c1"))
    x = L.max_pool(x)
    x = L.relu(L.conv2d(params["c2"], x, 1, "SAME", policy, path="c2"))
    x = L.max_pool(x)
    x = x.reshape(x.shape[0], -1)
    x = L.relu(L.dense(params["fc1"], x, policy, path="fc1"))
    return L.dense(params["fc2"], x, policy, path="fc2")


def cifarnet_init(gen: torch.Generator, num_classes: int = 10,
                  in_ch: int = 3, device: DeviceLike = "cuda"):
    return {"c1": L.conv2d_init(gen, in_ch, 32, 3, 3, device),
            "c2": L.conv2d_init(gen, 32, 64, 3, 3, device),
            "c3": L.conv2d_init(gen, 64, 128, 3, 3, device),
            "fc1": L.dense_init(gen, 128 * 4 * 4, 256, device),
            "fc2": L.dense_init(gen, 256, num_classes, device)}


def cifarnet_apply(params, x: torch.Tensor, policy: PolicyLike = None):
    x = L.relu(L.conv2d(params["c1"], x, 1, "SAME", policy, path="c1"))
    x = L.max_pool(x)
    x = L.relu(L.conv2d(params["c2"], x, 1, "SAME", policy, path="c2"))
    x = L.max_pool(x)
    x = L.relu(L.conv2d(params["c3"], x, 1, "SAME", policy, path="c3"))
    x = L.max_pool(x)
    x = x.reshape(x.shape[0], -1)
    x = L.relu(L.dense(params["fc1"], x, policy, path="fc1"))
    return L.dense(params["fc2"], x, policy, path="fc2")
