"""Canonical benchmark layer shapes — VGG-16 / ResNet-18 hot layers (a
copy of ``repro.tune.shapes``, so tuned entries key on the same problems
in both packages).

Conv shapes are (name, C, OC, kh, stride); the spatial extent comes from
the tuner's ``hw`` (32 full / 8 smoke).  GEMM shapes are the im2col views
of three representative convs plus the VGG classifier tail at batch 64.
"""
from __future__ import annotations

__all__ = ["CONV_LAYERS", "GEMM_LAYERS"]

#: (name, in_ch, out_ch, k, stride) — the tuner picks H = W = hw
CONV_LAYERS = (
    ("vgg16/conv1_1", 3, 64, 3, 1),
    ("vgg16/conv2_1", 64, 128, 3, 1),
    ("vgg16/conv3_1", 128, 256, 3, 1),
    ("vgg16/conv5_3", 512, 512, 3, 1),
    ("resnet18/stem7x7", 3, 64, 7, 2),
    ("resnet18/block_3x3", 64, 64, 3, 1),
    ("resnet18/down_3x3_s2", 128, 256, 3, 2),
)

#: (name, B, K, N) — im2col GEMM views at hw = 32 (B = batch*OH*OW) and
#: the classifier tail
GEMM_LAYERS = (
    ("vgg16/conv3_1.gemm", 1024, 1152, 256),
    ("vgg16/conv5_3.gemm", 1024, 4608, 512),
    ("resnet18/block.gemm", 1024, 576, 64),
    ("vgg16/fc.gemm", 64, 512, 4096),
)
