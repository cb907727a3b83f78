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
No padded input is written to device memory.  The tile kernel and the
prequant route through the mma core gather patch rows on chip; the
inline route writes the int8 patch matrix (one byte per element, with
its steps) between its two launches; the plain version materializes the
f32 patch matrix.

CPU tensors run the plain version, CUDA tensors launch
``csrc/bfp_conv.cu`` or raise.  ``LAUNCHES`` counts kernel launches per
wrapper; under ``bfp_conv2d_epilogue`` the layers that ran the
epilogue, under ``bfp_conv2d_xformat`` the activation format passes,
under ``bfp_conv2d_pformat`` the patch format passes, under
``bfp_conv2d_wformat`` the weight format passes and under
``bfp_conv2d_oformat`` the output format passes of the mma core's
routes.

Two cores, chosen by :func:`conv_core` (a pure function of shape and
policy).  The int8 ``mma.sync`` core (``csrc/bfp_mma.cuh``) takes every
conv whose ``bk`` is a power of two from 32 to 512, whose quantized
operands have L <= 8, whose OC is a multiple of 4 and whose epilogue, if
any, has an ``out_block`` that is a multiple of 4:

* the convs with x on the wire or formatted to it, when ``bk`` also
  divides C (:func:`mma_core`).  The prequant conv first block-formats
  its f32 input once per (pixel, channel chunk) with the tile kernels'
  rules (:func:`bfp_conv2d_xformat`; plain version
  :func:`bfp_conv2d_xformat_plain`) and runs the core on that wire
  format; the x-prequant conv first block-formats its float weight once
  per (K-tile, column) (:func:`bfp_conv2d_wformat`; plain version
  :func:`bfp_conv2d_wformat_plain`) into the prequant sidecar layout;
  the xw-prequant conv runs the core alone;
* the inline-weight conv, whatever C (:func:`patch_core`).  One patch
  format pass (:func:`bfp_conv2d_pformat`; plain version
  :func:`bfp_conv2d_pformat_plain`) block-formats the patch matrix per
  (row, K-tile) and the weight per (K-tile, column), the blocks the tile
  kernel forms inline, and the core runs as a 1x1 conv over the patch
  matrix ``[1, M, 1, Kp]``.

With ``out_bits`` the core's f32 output goes to a scratch tensor and the
activation format pass formats it per (pixel, ``out_block`` channel
chunk): the requantize epilogue, with the tile kernel's block rules on
the tile kernel's accumulator.  Each route issues its passes and the
core from one host call.  Every other conv (L > 8, other blocks,
OC % 4 != 0, an ``out_block`` of 1 or 2) runs on the tile kernel
(``csrc/bfp_tile.cuh``).  The outputs are bit-identical either way; a
failed build or launch raises, it never falls back to the other core.
The core's shape rules and launch helpers live in ``kernels._mma``,
which the f32-output matmuls share: a matmul runs there as the 1x1 conv
over x viewed as ``[1, B, 1, K]`` (``kernels.bfp_matmul.matmul_core``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.conv_utils import conv_geometry, im2col
from repro_torch.kernels._mma import (_INT_MAX, MMA_MAX_BK, MMA_TILES,
                                      _aligned, _check_cuda, _launch_mma,
                                      _launch_patch, _lib, _on, _outputs,
                                      _patch, _ptr, _raise_on, _stream,
                                      mma_core, mma_tile, patch_core)
from repro_torch.kernels.bfp_matmul import (Out, _check_wire, _finish_plain,
                                            _pad_k, _weights_inline,
                                            _weights_wire, check_epilogue,
                                            check_overflow, requant_plain,
                                            tiled_plain, wire_plain)

__all__ = ["bfp_conv2d", "bfp_conv2d_prequant", "bfp_conv2d_xprequant",
           "bfp_conv2d_xwprequant", "bfp_conv2d_xformat", "bfp_conv2d_plain",
           "bfp_conv2d_prequant_plain", "bfp_conv2d_xprequant_plain",
           "bfp_conv2d_xwprequant_plain", "bfp_conv2d_xformat_plain",
           "bfp_conv2d_pformat", "bfp_conv2d_pformat_plain",
           "bfp_conv2d_wformat", "bfp_conv2d_wformat_plain", "mma_core",
           "patch_core", "mma_tile", "conv_core", "MMA_TILES", "LAUNCHES"]

#: kernel launches per wrapper, incremented only where a kernel launches;
#: ``bfp_conv2d_epilogue`` counts the layers that ran the requantize
#: epilogue, ``bfp_conv2d_xformat`` the activation format passes,
#: ``bfp_conv2d_pformat`` the patch format passes, ``bfp_conv2d_wformat``
#: the weight format passes and ``bfp_conv2d_oformat`` the output format
#: passes (the epilogue on the mma core)
LAUNCHES = {"bfp_conv2d": 0, "bfp_conv2d_prequant": 0,
            "bfp_conv2d_xprequant": 0, "bfp_conv2d_xwprequant": 0,
            "bfp_conv2d_epilogue": 0, "bfp_conv2d_xformat": 0,
            "bfp_conv2d_pformat": 0, "bfp_conv2d_wformat": 0,
            "bfp_conv2d_oformat": 0}


def conv_core(wire_x: bool, prequant_w: bool, bk: int, c: int, n: int,
              l_i: int, out_bits: Optional[int] = None,
              l_w: Optional[int] = None,
              out_block: Optional[int] = None) -> str:
    """"mma" or "tile": the core a conv call of this mode runs on.
    ``l_w`` is the L of float weights quantized in the call (None: the
    same as ``l_i``); ``out_bits``/``out_block`` the epilogue's."""
    l_w = l_i if l_w is None else l_w
    if prequant_w:
        on_mma = mma_core(bk, c, n, out_bits, None if wire_x else l_i,
                          out_block)
    elif wire_x:
        on_mma = mma_core(bk, c, n, out_bits, l_w, out_block)
    else:
        on_mma = patch_core(bk, n, out_bits, l_i, l_w, out_block)
    return "mma" if on_mma else "tile"


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


def bfp_conv2d_xformat_plain(x: torch.Tensor, l_i: int,
                             bk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the format pass: f32 NHWC x block-formatted per
    (pixel, ``bk`` channel chunk) with the kernels' block rules ->
    (int8 [B, H, W, C], f32 steps [B, H, W, C // bk])."""
    return requant_plain(x.float(), l_i, bk)


def bfp_conv2d_pformat_plain(x: torch.Tensor, w_hwio: torch.Tensor, l_i: int,
                             l_w: int, bk: int, stride: int = 1,
                             padding: str = "SAME"):
    """Plain version of the patch format pass: the im2col patch matrix of
    f32 NHWC x, zero-padded to Kp = n_k * ``bk``, block-formatted per
    (row, K-tile), and the float GEMM-view weight per (K-tile, column),
    with the kernels' block rules -> (int8 [M, Kp], f32 steps [M, n_k],
    int8 [Kp, OC], f32 steps [n_k, OC])."""
    kh, kw, _, _ = w_hwio.shape
    cols, _ = im2col(x.float(), kh, kw, stride, padding)
    wm, ws = bfp_conv2d_wformat_plain(w_hwio, l_w, bk)
    xm, xs = requant_plain(_pad_k(cols, wm.shape[0], 1), l_i, bk)
    return xm, xs, wm, ws


def bfp_conv2d_wformat_plain(w_hwio: torch.Tensor, l_w: int,
                             bk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the weight format pass (the patch format pass's
    weight half): the float GEMM-view weight, zero-padded to Kp = n_k *
    ``bk``, block-formatted per (K-tile, column) with the kernels' block
    rules -> (int8 [Kp, OC], f32 steps [n_k, OC]), the prequant sidecar
    layout."""
    kh, kw, c, oc = w_hwio.shape
    mw, sw = _weights_inline(w_hwio.reshape(kh * kw * c, oc), l_w, bk)
    n_k = mw.shape[0]
    return mw.to(torch.int8).reshape(n_k * bk, oc), sw.reshape(n_k, oc)


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


def bfp_conv2d_xformat(x: torch.Tensor, *, l_i: int,
                       bk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The activation format pass: f32 NHWC x -> (int8 mantissas
    [B, H, W, C], f32 steps [B, H, W, C // bk]), one block per (pixel,
    ``bk`` channel chunk), the kernels' block rules (a NaN, inf or
    subnormal amax as the tile kernel reads it, not ``prequant_act``'s
    frexp)."""
    if x.ndim != 4 or bk < 1 or x.shape[3] % bk or bk % 4:
        raise ValueError(f"format pass needs NHWC x with bk | C and 4 | bk, "
                         f"got {tuple(x.shape)}, bk={bk}")
    if not 2 <= l_i <= 8:
        raise ValueError(f"format pass emits int8 mantissas, got L={l_i}")
    if x.device.type == "cpu":
        return bfp_conv2d_xformat_plain(x, l_i, bk)
    return _launch_xformat(x, l_i, bk)


def _launch_xformat(x: torch.Tensor, l_i: int,
                    bk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    x = _aligned(x.float().contiguous())
    dev = _check_cuda(x)
    b, h, w, c = x.shape
    xm = torch.empty(x.shape, dtype=torch.int8, device=dev)
    xs = torch.empty((b, h, w, c // bk), dtype=torch.float32, device=dev)
    if x.numel():
        with _on(dev):
            _raise_on(_lib().bfp_conv_xformat_launch(
                x.data_ptr(), xm.data_ptr(), xs.data_ptr(), x.numel() // bk,
                bk, l_i, _stream(dev)), "bfp_conv2d_xformat")
        LAUNCHES["bfp_conv2d_xformat"] += 1
    return xm, xs


def _launch_pformat(x: torch.Tensor, w: torch.Tensor, l_i: int, l_w: int,
                    bk: int, stride: int, padding: str):
    """The patch format pass alone, every row in one launch -> the four
    tensors of :func:`bfp_conv2d_pformat_plain`."""
    x, w = _aligned(x.float().contiguous()), w.float().contiguous()
    dev = _check_cuda(x, w)
    geo = _patch(x.shape, w.shape, bk, stride, padding, False)
    geo.check(x)
    oc = geo.out_shape[3]
    outs = tuple(torch.empty(shape, dtype=dt, device=dev) for dt, shape in (
        (torch.int8, (geo.m, geo.kp)), (torch.float32, (geo.m, geo.n_k)),
        (torch.int8, (geo.kp, oc)), (torch.float32, (geo.n_k, oc))))
    if geo.m and oc:
        with _on(dev):
            _raise_on(_lib().bfp_conv_pformat_launch(
                x.data_ptr(), w.data_ptr(), *(t.data_ptr() for t in outs),
                0, geo.m, 1, *geo.dims, bk, l_i, l_w, _stream(dev)),
                "bfp_conv2d_pformat")
        LAUNCHES["bfp_conv2d_pformat"] += 1
    return outs


def _launch_wformat(w: torch.Tensor, l_w: int, bk: int):
    """The weight format pass alone (the patch format pass with no patch
    rows) -> the two tensors of :func:`bfp_conv2d_wformat_plain`."""
    w = w.float().contiguous()
    dev = _check_cuda(w)
    kh, kw, c, oc = w.shape
    n_k = -(-kh * kw * c // bk)
    if n_k * bk * oc > _INT_MAX:
        raise ValueError(f"weight {tuple(w.shape)} exceeds the kernel's "
                         f"int32 indexing")
    wm = torch.empty((n_k * bk, oc), dtype=torch.int8, device=dev)
    ws = torch.empty((n_k, oc), dtype=torch.float32, device=dev)
    if oc:
        with _on(dev):
            _raise_on(_lib().bfp_conv_pformat_launch(
                None, w.data_ptr(), None, None, wm.data_ptr(),
                ws.data_ptr(), 0, 0, 1, 1, 1, c, kh, kw, oc, 1, 1, 1, 0, 0,
                bk, l_w, l_w, _stream(dev)), "bfp_conv2d_wformat")
        LAUNCHES["bfp_conv2d_wformat"] += 1
    return wm, ws


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
        with _on(dev):
            _raise_on(_lib().bfp_conv_launch(
                x.data_ptr(), _ptr(xs), w.data_ptr(), _ptr(ws),
                out.data_ptr(), _ptr(out_s), b, h, wd, c, kh, kw, oc, stride,
                oh, ow, pt, pl, bk, l_i, l_w, int(xs is not None),
                int(ws is not None), out_bits or 0, out_block or 0,
                _stream(dev)), name)
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
    if patch_core(bk, w_hwio.shape[3], out_bits, l_i, l_w, out_block):
        return _launch_patch(x, w_hwio, l_i, l_w, bk, stride, padding,
                             LAUNCHES, "bfp_conv2d", out_bits, out_block)
    return _launch(x.float().contiguous(), None, w_hwio.float().contiguous(),
                   None, l_i, l_w, bk, stride, padding, out_bits, out_block,
                   "bfp_conv2d")


def bfp_conv2d_pformat(x: torch.Tensor, w_hwio: torch.Tensor, *, l_i: int,
                       l_w: int, bk: int, stride: int = 1,
                       padding: str = "SAME"):
    """The patch format pass of the inline conv on its own: f32 NHWC x and
    float HWIO w -> (int8 patch mantissas [M, Kp], f32 steps [M, n_k],
    int8 weight mantissas [Kp, OC], f32 steps [n_k, OC]), one block per
    (patch row, K-tile) and per (K-tile, column), the tile kernel's block
    rules; Kp = n_k * ``bk``."""
    _check_geometry(x, w_hwio.shape, stride)
    if not (32 <= bk <= MMA_MAX_BK and bk & (bk - 1) == 0
            and 2 <= l_i <= 8 and 2 <= l_w <= 8):
        raise ValueError(f"patch format pass needs a power-of-two bk from 32 "
                         f"to {MMA_MAX_BK} and L <= 8 (int8 mantissas), got "
                         f"bk={bk}, L={l_i}/{l_w}")
    if x.device.type == "cpu":
        return bfp_conv2d_pformat_plain(x, w_hwio, l_i, l_w, bk, stride,
                                        padding)
    return _launch_pformat(x, w_hwio, l_i, l_w, bk, stride, padding)


def bfp_conv2d_wformat(w_hwio: torch.Tensor, *, l_w: int,
                       bk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The weight format pass on its own (what the x-prequant conv runs
    before the mma core): float HWIO w -> (int8 mantissas [Kp, OC], f32
    steps [n_k, OC]), one block per (K-tile, column), the tile kernel's
    block rules, in the prequant sidecar layout; Kp = n_k * ``bk``."""
    if w_hwio.ndim != 4:
        raise ValueError(f"expected HWIO w, got {tuple(w_hwio.shape)}")
    if not (32 <= bk <= MMA_MAX_BK and bk & (bk - 1) == 0
            and 2 <= l_w <= 8):
        raise ValueError(f"weight format pass needs a power-of-two bk from "
                         f"32 to {MMA_MAX_BK} and L <= 8 (int8 mantissas), "
                         f"got bk={bk}, L={l_w}")
    if w_hwio.device.type == "cpu":
        return bfp_conv2d_wformat_plain(w_hwio, l_w, bk)
    return _launch_wformat(w_hwio, l_w, bk)


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
    if mma_core(bk, x.shape[3], wm_hwio.shape[3], out_bits, l_i,
                out_block):
        wm, ws = wm_hwio.contiguous(), ws.float().contiguous()
        if out_bits is None:
            # the served route keeps its two host calls (the pass, then
            # the core); passing x to the core's call would fold them
            xm, xs = _launch_xformat(x, l_i, bk)
            return _launch_mma(xm, xs, wm, ws, bk, stride, padding,
                               LAUNCHES, "bfp_conv2d", "bfp_conv2d_prequant")
        return _launch_mma(None, None, wm, ws, bk, stride, padding,
                           LAUNCHES, "bfp_conv2d", "bfp_conv2d_prequant",
                           x=x, l_i=l_i, out_bits=out_bits,
                           out_block=out_block)
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
    if mma_core(bk, xm.shape[3], w_hwio.shape[3], out_bits, l_w, out_block):
        return _launch_mma(xm.contiguous(), xs.float().contiguous(), None,
                           None, bk, stride, padding, LAUNCHES, "bfp_conv2d",
                           "bfp_conv2d_xprequant", w=w_hwio, l_w=l_w,
                           out_bits=out_bits, out_block=out_block)
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
    if mma_core(bk, xm.shape[3], wm_hwio.shape[3], out_bits,
                out_block=out_block):
        return _launch_mma(xm.contiguous(), xs.float().contiguous(),
                           wm_hwio.contiguous(), ws.float().contiguous(), bk,
                           stride, padding, LAUNCHES, "bfp_conv2d",
                           "bfp_conv2d_xwprequant", out_bits=out_bits,
                           out_block=out_block)
    return _launch(xm.contiguous(), xs.float().contiguous(),
                   wm_hwio.contiguous(), ws.float().contiguous(), l_i, l_w,
                   bk, stride, padding, out_bits, out_block,
                   "bfp_conv2d_xwprequant")
