"""CNN layers with the BFP datapath (counterpart of
``repro.models.cnn.layers``).

Convolution is the paper's matrix form ``O = I @ W`` executed by
:func:`repro_torch.engine.conv2d` (the fused implicit-im2col CUDA kernel
on the cuda backend).  Activations are NHWC and conv weights HWIO, as in
``repro``.  Parameters are plain dicts of tensors; initializers draw from
an explicit ``torch.Generator`` and place the result on ``device``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import engine as EG
from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.conv_utils import conv_geometry
from repro_torch.engine import PolicyLike

__all__ = ["conv2d_init", "conv2d", "dense_init", "dense", "batchnorm_init",
           "batchnorm", "max_pool", "avg_pool", "global_avg_pool", "relu"]


def _he_init(gen: torch.Generator, shape, fan_in: int,
             device: torch.device) -> torch.Tensor:
    # drawn on the generator's device, so one seed gives the same weights
    # wherever they are placed; on the meta device (a shape-only template,
    # as a cold start restores into) nothing is drawn
    if device.type == "meta":
        return torch.empty(shape, device=device)
    w = torch.randn(shape, generator=gen, device=gen.device)
    return (w * math.sqrt(2.0 / fan_in)).to(device)


def conv2d_init(gen: torch.Generator, in_ch: int, out_ch: int, kh: int,
                kw: int, device: DeviceLike = "cuda"):
    """He-initialized HWIO [kh, kw, in_ch, out_ch] kernel + zero bias."""
    dev = resolve_device(device)
    return {"w": _he_init(gen, (kh, kw, in_ch, out_ch), kh * kw * in_ch, dev),
            "b": torch.zeros((out_ch,), dtype=torch.float32, device=dev)}


def conv2d(params, x: torch.Tensor, stride: int = 1, padding: str = "SAME",
           policy: PolicyLike = None,
           path: Optional[str] = None) -> torch.Tensor:
    """BFP convolution through :func:`repro_torch.engine.conv2d` (NHWC);
    ``params["w"]`` is an HWIO float kernel or its prequant form."""
    return EG.conv2d(x, params["w"], policy, stride=stride,
                     padding=padding, path=path) + params["b"]


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               device: DeviceLike = "cuda"):
    dev = resolve_device(device)
    return {"w": _he_init(gen, (in_dim, out_dim), in_dim, dev),
            "b": torch.zeros((out_dim,), dtype=torch.float32, device=dev)}


def dense(params, x: torch.Tensor, policy: PolicyLike = None,
          path: Optional[str] = None) -> torch.Tensor:
    return EG.gemm(x, params["w"], policy, path=path) + params["b"]


def batchnorm_init(ch: int, device: DeviceLike = "cuda"):
    dev = resolve_device(device)
    return {"gamma": torch.ones((ch,), device=dev),
            "beta": torch.zeros((ch,), device=dev),
            "mean": torch.zeros((ch,), device=dev),
            "var": torch.ones((ch,), device=dev)}


def batchnorm(params, x: torch.Tensor, training: bool = False,
              eps: float = 1e-5) -> torch.Tensor:
    """Inference-mode BN (running statistics); ``training`` uses the batch
    statistics instead (no running-average state)."""
    if training:
        axes = tuple(range(x.ndim - 1))
        mean = x.mean(axes)
        var = x.var(axes, unbiased=False)
    else:
        mean, var = params["mean"], params["var"]
    inv = torch.rsqrt(var + eps) * params["gamma"]
    return x * inv + (params["beta"] - mean * inv)


def _pool_pads(x: torch.Tensor, window: int, stride: int, padding: str):
    _, h, w, _ = x.shape
    _, _, (pt, pb), (pl, pr) = conv_geometry(h, w, window, window, stride,
                                             padding)
    return (pl, pr, pt, pb)


def max_pool(x: torch.Tensor, window: int = 2, stride: int = 2,
             padding: str = "VALID") -> torch.Tensor:
    """NHWC max pool; padding counts as -inf (``reduce_window`` with a
    -inf init)."""
    xc = F.pad(x.permute(0, 3, 1, 2), _pool_pads(x, window, stride, padding),
               value=float("-inf"))
    return F.max_pool2d(xc, window, stride).permute(0, 2, 3, 1).contiguous()


def avg_pool(x: torch.Tensor, window: int, stride: int,
             padding: str = "VALID") -> torch.Tensor:
    """NHWC average pool; padding counts as zeros in a window of
    ``window**2`` (``reduce_window`` sum / window**2)."""
    xc = F.pad(x.permute(0, 3, 1, 2), _pool_pads(x, window, stride, padding))
    return F.avg_pool2d(xc, window, stride).permute(0, 2, 3, 1).contiguous()


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=(1, 2))


relu = torch.relu
