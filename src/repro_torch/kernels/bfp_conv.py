"""Implicit-im2col BFP convolution: CUDA kernel wrappers and their plain
PyTorch versions.

Counterpart of ``repro.kernels.bfp_conv`` (``bfp_conv2d_pallas``,
``bfp_conv2d_prequant_pallas``, ``bfp_conv2d_xprequant_pallas`` and
``bfp_conv2d_xwprequant_pallas``).  The conv is the BFP GEMM of the patch
matrix in HWIO-major K-order (k = (di*kw + dj)*C + c) with the GEMM view
of the HWIO weight, K zero-padded to a ``bk`` multiple — bit-identical
to im2col + the fused matmul.  Wire-format activations (int8 NHWC
mantissas + f32 steps [B, H, W, C // bk], the conv epilogue's output)
need ``bk | C``: each patch K-tile is then one (pixel, channel chunk)
block, so gathering mantissa and step patches equals quantizing the
float patches inline.  ``out_bits``/``out_block`` request the requantize
epilogue: ``(int8 [B, OH, OW, OC], f32 steps [B, OH, OW, OC // out_block])``.
The CUDA kernel gathers the patch rows on chip, so no patch matrix or
padded input is written to device memory; the plain version
materializes both.

CPU tensors run the plain version, CUDA tensors launch
``csrc/bfp_conv.cu`` or raise.  ``LAUNCHES`` counts kernel launches per
wrapper, and under ``bfp_conv2d_epilogue`` those that ran the epilogue.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.conv_utils import conv_geometry, im2col
from repro_torch.kernels import _build
from repro_torch.kernels.bfp_matmul import (_INT_MAX, Out, _check_cuda,
                                            _check_wire, _finish_plain,
                                            _outputs, _pad_k, _ptr,
                                            _weights_inline, _weights_wire,
                                            check_epilogue, check_overflow,
                                            tiled_plain, wire_plain)

__all__ = ["bfp_conv2d", "bfp_conv2d_prequant", "bfp_conv2d_xprequant",
           "bfp_conv2d_xwprequant", "bfp_conv2d_plain",
           "bfp_conv2d_prequant_plain", "bfp_conv2d_xprequant_plain",
           "bfp_conv2d_xwprequant_plain", "LAUNCHES"]

#: kernel launches per wrapper, incremented only where a kernel launches;
#: ``bfp_conv2d_epilogue`` counts those that ran the fused epilogue
LAUNCHES = {"bfp_conv2d": 0, "bfp_conv2d_prequant": 0,
            "bfp_conv2d_xprequant": 0, "bfp_conv2d_xwprequant": 0,
            "bfp_conv2d_epilogue": 0}


def bfp_conv2d_plain(x: torch.Tensor, w_hwio: torch.Tensor, l_i: int,
                     l_w: int, bk: int, stride: int = 1,
                     padding: str = "SAME", out_bits: Optional[int] = None,
                     out_block: Optional[int] = None) -> Out:
    """Plain version of the inline-weight conv kernel (NHWC / HWIO)."""
    kh, kw, c, oc = w_hwio.shape
    cols, (b, oh, ow) = im2col(x.float(), kh, kw, stride, padding)
    mw, sw = _weights_inline(w_hwio.reshape(kh * kw * c, oc), l_w, bk)
    out = tiled_plain(_pad_k(cols, mw.shape[0] * bk, 1), mw, sw, l_i, l_w,
                      bk)
    return _finish_plain(out.reshape(b, oh, ow, oc), out_bits, out_block)


def bfp_conv2d_prequant_plain(x: torch.Tensor, wm_hwio: torch.Tensor,
                              ws: torch.Tensor, l_i: int, l_w: int, bk: int,
                              stride: int = 1, padding: str = "SAME",
                              out_bits: Optional[int] = None,
                              out_block: Optional[int] = None) -> Out:
    """Plain version of the prequant conv kernel: int8 HWIO mantissas,
    steps [K//bk, OC] in the GEMM view."""
    kh, kw, c, oc = wm_hwio.shape
    cols, (b, oh, ow) = im2col(x.float(), kh, kw, stride, padding)
    mw, sw = _weights_wire(wm_hwio.reshape(kh * kw * c, oc), ws, bk)
    out = tiled_plain(cols, mw, sw, l_i, min(l_w, 8), bk)
    return _finish_plain(out.reshape(b, oh, ow, oc), out_bits, out_block)


def _wire_patches(xm: torch.Tensor, xs: torch.Tensor, kh: int, kw: int,
                  stride: int, padding: str):
    """Mantissa and step patch matrices of a wire-format NHWC input:
    mantissas 0 and steps 1.0 outside the image (repro's
    ``ops._pad_act_nhwc``).  With ``bk | C`` the step patches
    [B*OH*OW, kh*kw*C/bk] run in K-tile order."""
    cols_m, geo = im2col(xm.float(), kh, kw, stride, padding)
    cols_s, _ = im2col(xs.float(), kh, kw, stride, padding, value=1.0)
    return cols_m, cols_s, geo


def bfp_conv2d_xprequant_plain(xm: torch.Tensor, xs: torch.Tensor,
                               w_hwio: torch.Tensor, l_i: int, l_w: int,
                               bk: int, stride: int = 1,
                               padding: str = "SAME",
                               out_bits: Optional[int] = None,
                               out_block: Optional[int] = None) -> Out:
    """Plain version of the x-prequant conv kernel: wire-format NHWC
    activations, float HWIO weights quantized per (column, K-tile)."""
    kh, kw, c, oc = w_hwio.shape
    cols_m, cols_s, (b, oh, ow) = _wire_patches(xm, xs, kh, kw, stride,
                                                padding)
    mw, sw = _weights_inline(w_hwio.reshape(kh * kw * c, oc), l_w, bk)
    out = wire_plain(cols_m, cols_s, mw, sw, l_w, bk)
    return _finish_plain(out.reshape(b, oh, ow, oc), out_bits, out_block)


def bfp_conv2d_xwprequant_plain(xm: torch.Tensor, xs: torch.Tensor,
                                wm_hwio: torch.Tensor, ws: torch.Tensor,
                                l_i: int, l_w: int, bk: int, stride: int = 1,
                                padding: str = "SAME",
                                out_bits: Optional[int] = None,
                                out_block: Optional[int] = None) -> Out:
    """Plain version of the conv kernel with both operands on the wire."""
    kh, kw, c, oc = wm_hwio.shape
    cols_m, cols_s, (b, oh, ow) = _wire_patches(xm, xs, kh, kw, stride,
                                                padding)
    mw, sw = _weights_wire(wm_hwio.reshape(kh * kw * c, oc), ws, bk)
    out = wire_plain(cols_m, cols_s, mw, sw, 8, bk)
    return _finish_plain(out.reshape(b, oh, ow, oc), out_bits, out_block)


def _lib() -> ctypes.CDLL:
    lib = _build.load("bfp_conv")
    fn = lib.bfp_conv_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 19
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _launch(x, xs, w, ws, l_i, l_w, bk, stride, padding, out_bits,
            out_block, name) -> Out:
    b, h, wd, c = x.shape
    kh, kw, _, oc = w.shape
    oh, ow, (pt, _), (pl, _) = conv_geometry(h, wd, kh, kw, stride, padding)
    rows = b * oh * ow
    if max(rows, x.numel(), kh * kw * c * oc) > _INT_MAX or \
            -(-oc // 64) > 65535:
        raise ValueError(f"conv {tuple(x.shape)} * {tuple(w.shape)} exceeds "
                         f"the kernel's int32 indexing / grid")
    dev = _check_cuda(x, xs, w, ws)
    out, out_s = _outputs((b, oh, ow, oc), out_bits, out_block, dev)
    if rows and oc:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = _lib().bfp_conv_launch(
                x.data_ptr(), _ptr(xs), w.data_ptr(), _ptr(ws),
                out.data_ptr(), _ptr(out_s), b, h, wd, c, kh, kw, oc, stride,
                oh, ow, pt, pl, bk, l_i, l_w, int(xs is not None),
                int(ws is not None), out_bits or 0, out_block or 0, stream)
        if rc:
            raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                               f"{rc}")
        LAUNCHES[name] += 1
        if out_bits is not None:
            LAUNCHES["bfp_conv2d_epilogue"] += 1
    return out if out_bits is None else (out, out_s)


def _check_geometry(x: torch.Tensor, w_shape, stride: int) -> None:
    if x.ndim != 4 or len(w_shape) != 4:
        raise ValueError(f"expected NHWC x and HWIO w, got {tuple(x.shape)} "
                         f"and {tuple(w_shape)}")
    if x.shape[3] != w_shape[2]:
        raise ValueError(f"channel mismatch: x {tuple(x.shape)} vs w "
                         f"{tuple(w_shape)}")
    if not isinstance(stride, int) or stride < 1:
        raise ValueError(f"stride must be a positive int, got {stride!r}")


def _check_sidecar(w_shape, ws: torch.Tensor, bk: int) -> None:
    kh, kw, c, oc = w_shape
    k = kh * kw * c
    if k % bk or tuple(ws.shape) != (k // bk, oc):
        raise ValueError(f"scale sidecar {tuple(ws.shape)} != "
                         f"{(k // bk, oc)} for bk={bk}")


def _check_act(xm: torch.Tensor, xs: torch.Tensor, bk: int) -> None:
    c = xm.shape[3]
    if c % bk:
        raise ValueError(f"activation prequant requires bk | C, got "
                         f"bk={bk}, C={c}")
    if tuple(xs.shape) != (*xm.shape[:3], c // bk):
        raise ValueError(f"activation sidecar {tuple(xs.shape)} != "
                         f"{(*xm.shape[:3], c // bk)} for bk={bk}")
    _check_wire(xm, "activation-prequant conv")


def bfp_conv2d(x: torch.Tensor, w_hwio: torch.Tensor, *, l_i: int, l_w: int,
               bk: int, stride: int = 1, padding: str = "SAME",
               out_bits: Optional[int] = None,
               out_block: Optional[int] = None) -> Out:
    """NHWC conv with float HWIO weights, both operands quantized per
    K-tile of ``bk`` (the BFP block) in the kernel -> f32 NHWC."""
    _check_geometry(x, w_hwio.shape, stride)
    check_overflow(bk, l_i + l_w)
    check_epilogue(out_bits, out_block, w_hwio.shape[3])
    if x.device.type == "cpu":
        return bfp_conv2d_plain(x, w_hwio, l_i, l_w, bk, stride, padding,
                                out_bits, out_block)
    return _launch(x.float().contiguous(), None, w_hwio.float().contiguous(),
                   None, l_i, l_w, bk, stride, padding, out_bits, out_block,
                   "bfp_conv2d")


def bfp_conv2d_prequant(x: torch.Tensor, wm_hwio: torch.Tensor,
                        ws: torch.Tensor, *, l_i: int, l_w: int, bk: int,
                        stride: int = 1, padding: str = "SAME",
                        out_bits: Optional[int] = None,
                        out_block: Optional[int] = None) -> Out:
    """NHWC conv with prequant weights (int8 HWIO mantissa + GEMM-view
    steps [K//bk, OC]); ``l_w`` only sizes the overflow check."""
    _check_geometry(x, wm_hwio.shape, stride)
    check_overflow(bk, l_i + l_w)
    _check_sidecar(wm_hwio.shape, ws, bk)
    _check_wire(wm_hwio, "prequant conv")
    check_epilogue(out_bits, out_block, wm_hwio.shape[3])
    if x.device.type == "cpu":
        return bfp_conv2d_prequant_plain(x, wm_hwio, ws, l_i, l_w, bk, stride,
                                         padding, out_bits, out_block)
    return _launch(x.float().contiguous(), None, wm_hwio.contiguous(),
                   ws.float().contiguous(), l_i, l_w, bk, stride, padding,
                   out_bits, out_block, "bfp_conv2d_prequant")


def bfp_conv2d_xprequant(xm: torch.Tensor, xs: torch.Tensor,
                         w_hwio: torch.Tensor, *, l_i: int, l_w: int,
                         bk: int, stride: int = 1, padding: str = "SAME",
                         out_bits: Optional[int] = None,
                         out_block: Optional[int] = None) -> Out:
    """Wire-format NHWC activations (int8 mantissa + steps per (pixel,
    C-chunk), ``bk | C``) with float HWIO weights; ``l_i`` only sizes
    the overflow check."""
    _check_geometry(xm, w_hwio.shape, stride)
    check_overflow(bk, l_i + l_w)
    _check_act(xm, xs, bk)
    check_epilogue(out_bits, out_block, w_hwio.shape[3])
    if xm.device.type == "cpu":
        return bfp_conv2d_xprequant_plain(xm, xs, w_hwio, l_i, l_w, bk,
                                          stride, padding, out_bits,
                                          out_block)
    return _launch(xm.contiguous(), xs.float().contiguous(),
                   w_hwio.float().contiguous(), None, l_i, l_w, bk, stride,
                   padding, out_bits, out_block, "bfp_conv2d_xprequant")


def bfp_conv2d_xwprequant(xm: torch.Tensor, xs: torch.Tensor,
                          wm_hwio: torch.Tensor, ws: torch.Tensor, *,
                          l_i: int, l_w: int, bk: int, stride: int = 1,
                          padding: str = "SAME",
                          out_bits: Optional[int] = None,
                          out_block: Optional[int] = None) -> Out:
    """Both operands on the wire — the steady state of a conv->conv
    chain on a bound plan: no quantization in the kernel."""
    _check_geometry(xm, wm_hwio.shape, stride)
    check_overflow(bk, l_i + l_w)
    _check_act(xm, xs, bk)
    _check_sidecar(wm_hwio.shape, ws, bk)
    _check_wire(wm_hwio, "prequant conv")
    check_epilogue(out_bits, out_block, wm_hwio.shape[3])
    if xm.device.type == "cpu":
        return bfp_conv2d_xwprequant_plain(xm, xs, wm_hwio, ws, l_i, l_w, bk,
                                           stride, padding, out_bits,
                                           out_block)
    return _launch(xm.contiguous(), xs.float().contiguous(),
                   wm_hwio.contiguous(), ws.float().contiguous(), l_i, l_w,
                   bk, stride, padding, out_bits, out_block,
                   "bfp_conv2d_xwprequant")
