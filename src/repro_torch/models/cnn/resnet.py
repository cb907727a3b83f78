"""ResNet-18 / ResNet-50 (He et al. 2016) with the BFP conv datapath
(counterpart of ``repro.models.cnn.resnet``).

Inference-mode batch norm (the paper deploys trained models without
retraining); ``width_mult``/``stage_depths`` build reduced configs of the
same family for tests.  Every conv (the 7x7/2 stem, the 1x1 and 3x3
convs, the strided projection shortcuts) runs through
``engine.conv2d``; the classifier through ``engine.gemm``.
``params["meta"]`` is a tuple of Python ints and a bool, carried through
conversion and binding unchanged.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch._device import DeviceLike
from repro_torch.engine import PolicyLike, join_path
from repro_torch.models.cnn import layers as L

__all__ = ["init", "apply"]


def _conv_bn_init(gen, in_ch, out_ch, k, device):
    return {"conv": L.conv2d_init(gen, in_ch, out_ch, k, k, device),
            "bn": L.batchnorm_init(out_ch, device)}


def _conv_bn(p, x, stride, policy, training, act=True, path=None):
    x = L.conv2d(p["conv"], x, stride, "SAME", policy, path=path)
    x = L.batchnorm(p["bn"], x, training)
    return L.relu(x) if act else x


def _basic_block_init(gen, in_ch, out_ch, stride, device):
    p = {"c1": _conv_bn_init(gen, in_ch, out_ch, 3, device),
         "c2": _conv_bn_init(gen, out_ch, out_ch, 3, device)}
    if stride != 1 or in_ch != out_ch:
        p["proj"] = _conv_bn_init(gen, in_ch, out_ch, 1, device)
    return p


def _basic_block(p, x, stride, policy, training, path=None):
    h = _conv_bn(p["c1"], x, stride, policy, training,
                 path=join_path(path, "c1"))
    h = _conv_bn(p["c2"], h, 1, policy, training, act=False,
                 path=join_path(path, "c2"))
    sc = _conv_bn(p["proj"], x, stride, policy, training, act=False,
                  path=join_path(path, "proj")) if "proj" in p else x
    return L.relu(h + sc)


def _bottleneck_init(gen, in_ch, mid_ch, stride, device):
    out_ch = mid_ch * 4
    p = {"c1": _conv_bn_init(gen, in_ch, mid_ch, 1, device),
         "c2": _conv_bn_init(gen, mid_ch, mid_ch, 3, device),
         "c3": _conv_bn_init(gen, mid_ch, out_ch, 1, device)}
    if stride != 1 or in_ch != out_ch:
        p["proj"] = _conv_bn_init(gen, in_ch, out_ch, 1, device)
    return p


def _bottleneck(p, x, stride, policy, training, path=None):
    h = _conv_bn(p["c1"], x, 1, policy, training,
                 path=join_path(path, "c1"))
    h = _conv_bn(p["c2"], h, stride, policy, training,
                 path=join_path(path, "c2"))
    h = _conv_bn(p["c3"], h, 1, policy, training, act=False,
                 path=join_path(path, "c3"))
    sc = _conv_bn(p["proj"], x, stride, policy, training, act=False,
                  path=join_path(path, "proj")) if "proj" in p else x
    return L.relu(h + sc)


_DEPTHS = {18: (2, 2, 2, 2), 50: (3, 4, 6, 3)}


def init(gen: torch.Generator, depth: int = 18, num_classes: int = 1000,
         in_ch: int = 3, width_mult: float = 1.0,
         stage_depths: Optional[Sequence[int]] = None,
         device: DeviceLike = "cuda"):
    """He-initialized ResNet params drawn from ``gen``, placed on
    ``device``; BN starts as the identity (``layers.batchnorm_init``)."""
    stage_depths = stage_depths or _DEPTHS[depth]
    bottleneck = depth >= 50
    base = max(8, int(64 * width_mult))
    params = {"stem": _conv_bn_init(gen, in_ch, base, 7, device)}
    ch = base
    blocks = []
    for si, nblocks in enumerate(stage_depths):
        out = base * (2 ** si)
        for bi in range(nblocks):
            stride = 2 if (bi == 0 and si > 0) else 1
            if bottleneck:
                blocks.append(_bottleneck_init(gen, ch, out, stride, device))
                ch = out * 4
            else:
                blocks.append(_basic_block_init(gen, ch, out, stride,
                                                device))
                ch = out
    params["blocks"] = blocks
    params["fc"] = L.dense_init(gen, ch, num_classes, device)
    params["meta"] = (depth, tuple(stage_depths), bottleneck)
    return params


def apply(params, x: torch.Tensor, policy: PolicyLike = None,
          training: bool = False) -> torch.Tensor:
    """NHWC images -> logits.  Layer paths: "stem",
    "blocks/<i>/c1|c2|c3|proj", "fc"; ``policy`` may be a bound Plan."""
    depth, stage_depths, bottleneck = params["meta"]
    x = _conv_bn(params["stem"], x, 2, policy, training, path="stem")
    x = L.max_pool(x, 3, 2, "SAME")
    bi = 0
    for si, nblocks in enumerate(stage_depths):
        for b in range(nblocks):
            stride = 2 if (b == 0 and si > 0) else 1
            blk = params["blocks"][bi]
            bpath = f"blocks/{bi}"
            x = (_bottleneck(blk, x, stride, policy, training, path=bpath)
                 if bottleneck
                 else _basic_block(blk, x, stride, policy, training,
                                   path=bpath))
            bi += 1
    x = L.global_avg_pool(x)
    return L.dense(params["fc"], x, policy, path="fc")
