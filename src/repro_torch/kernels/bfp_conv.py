"""Implicit-im2col BFP convolution: CUDA kernel wrappers and their plain
PyTorch versions.

Counterpart of ``repro.kernels.bfp_conv`` (``bfp_conv2d_pallas`` and
``bfp_conv2d_prequant_pallas``).  The conv is the BFP GEMM of the patch
matrix in HWIO-major K-order (k = (di*kw + dj)*C + c) with the GEMM view
of the HWIO weight, K zero-padded to a ``bk`` multiple — bit-identical
to im2col + the fused matmul.  The CUDA kernel gathers the patch rows on
chip, so no patch matrix or padded input is written to device memory;
the plain version materializes both.

CPU tensors run the plain version, CUDA tensors launch
``csrc/bfp_conv.cu`` or raise.  ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.conv_utils import conv_geometry, im2col
from repro_torch.kernels import _build
from repro_torch.kernels.bfp_matmul import (_INT_MAX, _check_cuda, _pad_k,
                                            block_format, check_overflow,
                                            tiled_plain)

__all__ = ["bfp_conv2d", "bfp_conv2d_prequant", "bfp_conv2d_plain",
           "bfp_conv2d_prequant_plain", "LAUNCHES"]

#: kernel launches per wrapper, incremented only where a kernel launches
LAUNCHES = {"bfp_conv2d": 0, "bfp_conv2d_prequant": 0}


def bfp_conv2d_plain(x: torch.Tensor, w_hwio: torch.Tensor, l_i: int,
                     l_w: int, bk: int, stride: int = 1,
                     padding: str = "SAME") -> torch.Tensor:
    """Plain version of the inline-weight conv kernel (NHWC / HWIO)."""
    kh, kw, c, oc = w_hwio.shape
    cols, (b, oh, ow) = im2col(x.float(), kh, kw, stride, padding)
    k = kh * kw * c
    kp = -(-k // bk) * bk
    wt = _pad_k(w_hwio.float().reshape(k, oc), kp, 0).reshape(kp // bk, bk,
                                                              oc)
    mw, sw = block_format(wt, l_w, dim=1)
    out = tiled_plain(_pad_k(cols, kp, 1), mw, sw, l_i, l_w, bk)
    return out.reshape(b, oh, ow, oc)


def bfp_conv2d_prequant_plain(x: torch.Tensor, wm_hwio: torch.Tensor,
                              ws: torch.Tensor, l_i: int, l_w: int, bk: int,
                              stride: int = 1,
                              padding: str = "SAME") -> torch.Tensor:
    """Plain version of the prequant conv kernel: int8 HWIO mantissas,
    steps [K//bk, OC] in the GEMM view."""
    kh, kw, c, oc = wm_hwio.shape
    cols, (b, oh, ow) = im2col(x.float(), kh, kw, stride, padding)
    k = kh * kw * c
    mw = wm_hwio.float().reshape(k // bk, bk, oc)
    sw = ws.float().reshape(k // bk, 1, oc)
    out = tiled_plain(cols, mw, sw, l_i, min(l_w, 8), bk)
    return out.reshape(b, oh, ow, oc)


def _lib() -> ctypes.CDLL:
    lib = _build.load("bfp_conv")
    fn = lib.bfp_conv_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 16
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _launch(x, w, ws, l_i, l_w, bk, stride, padding, name) -> torch.Tensor:
    b, h, wd, c = x.shape
    kh, kw, _, oc = w.shape
    oh, ow, (pt, _), (pl, _) = conv_geometry(h, wd, kh, kw, stride, padding)
    rows = b * oh * ow
    if max(rows, x.numel(), kh * kw * c * oc) > _INT_MAX or \
            -(-oc // 64) > 65535:
        raise ValueError(f"conv {tuple(x.shape)} * {tuple(w.shape)} exceeds "
                         f"the kernel's int32 indexing / grid")
    dev = _check_cuda(x, w, ws)
    out = torch.empty((b, oh, ow, oc), dtype=torch.float32, device=dev)
    if rows == 0 or oc == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().bfp_conv_launch(
            x.data_ptr(), w.data_ptr(), None if ws is None else ws.data_ptr(),
            out.data_ptr(), b, h, wd, c, kh, kw, oc, stride, oh, ow, pt, pl,
            bk, l_i, l_w, int(ws is not None), stream)
    if rc:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1
    return out


def _check_geometry(x: torch.Tensor, w_shape, stride: int) -> None:
    if x.ndim != 4 or len(w_shape) != 4:
        raise ValueError(f"expected NHWC x and HWIO w, got {tuple(x.shape)} "
                         f"and {tuple(w_shape)}")
    if x.shape[3] != w_shape[2]:
        raise ValueError(f"channel mismatch: x {tuple(x.shape)} vs w "
                         f"{tuple(w_shape)}")
    if not isinstance(stride, int) or stride < 1:
        raise ValueError(f"stride must be a positive int, got {stride!r}")


def bfp_conv2d(x: torch.Tensor, w_hwio: torch.Tensor, *, l_i: int, l_w: int,
               bk: int, stride: int = 1,
               padding: str = "SAME") -> torch.Tensor:
    """NHWC conv with float HWIO weights, both operands quantized per
    K-tile of ``bk`` (the BFP block) in the kernel -> f32 NHWC."""
    _check_geometry(x, w_hwio.shape, stride)
    check_overflow(bk, l_i + l_w)
    if x.device.type == "cpu":
        return bfp_conv2d_plain(x, w_hwio, l_i, l_w, bk, stride, padding)
    return _launch(x.float().contiguous(), w_hwio.float().contiguous(), None,
                   l_i, l_w, bk, stride, padding, "bfp_conv2d")


def bfp_conv2d_prequant(x: torch.Tensor, wm_hwio: torch.Tensor,
                        ws: torch.Tensor, *, l_i: int, l_w: int, bk: int,
                        stride: int = 1,
                        padding: str = "SAME") -> torch.Tensor:
    """NHWC conv with prequant weights (int8 HWIO mantissa + GEMM-view
    steps [K//bk, OC]); ``l_w`` only sizes the overflow check."""
    _check_geometry(x, wm_hwio.shape, stride)
    check_overflow(bk, l_i + l_w)
    kh, kw, c, oc = wm_hwio.shape
    k = kh * kw * c
    if k % bk or tuple(ws.shape) != (k // bk, oc):
        raise ValueError(f"scale sidecar {tuple(ws.shape)} != "
                         f"{(k // bk, oc)} for bk={bk}")
    if wm_hwio.dtype != torch.int8:
        raise ValueError(f"prequant conv kernel streams int8 mantissas, got "
                         f"{wm_hwio.dtype}")
    if x.device.type == "cpu":
        return bfp_conv2d_prequant_plain(x, wm_hwio, ws, l_i, l_w, bk, stride,
                                         padding)
    return _launch(x.float().contiguous(), wm_hwio.contiguous(),
                   ws.float().contiguous(), l_i, l_w, bk, stride, padding,
                   "bfp_conv2d_prequant")
