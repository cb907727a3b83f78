"""Carry weights across from ``repro``.

``jax.random`` initialization cannot be reproduced in PyTorch, so a
parameter tree exported from the JAX package as numpy arrays (float
leaves and ``{"m", "s"}`` prequant dicts alike) is loaded here into the
port's tree of tensors, dtypes and layouts unchanged (NHWC, HWIO, the
GEMM-view sidecars).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device

__all__ = ["params_from_numpy"]


def params_from_numpy(tree: Any, device: DeviceLike = "cuda") -> Any:
    """numpy leaves -> tensors on ``device``; dicts, lists and tuples keep
    their structure, anything else passes through."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        if isinstance(node, (np.ndarray, np.generic)):
            return torch.from_numpy(np.array(node, copy=True)).to(dev)
        return node

    return conv(tree)
