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
wrapper, under ``bfp_conv2d_epilogue`` those that ran the epilogue, and
under ``bfp_conv2d_xformat`` the activation format passes.

Two cores.  :func:`mma_core` (a pure function of shape and policy) sends
the weight-prequant conv and the xw-prequant conv with an f32 output to
the int8 ``mma.sync`` core (``csrc/bfp_mma.cuh``) when ``bk`` is a
power of two from 32 to 512 that divides C, x's bits (prequant) are at
most 8 and OC is a multiple of 4.  The prequant conv then first block-formats
its f32 input once per (pixel, channel chunk) with the tile kernels'
rules (:func:`bfp_conv2d_xformat`; plain version
:func:`bfp_conv2d_xformat_plain`) and runs the core on that wire format.
Every other conv (inline weights, x-prequant with float weights, the
requantize epilogue, L > 8, other blocks) runs on the tile kernel
(``csrc/bfp_tile.cuh``).  The outputs are bit-identical either way; a
failed build or launch raises, it never falls back to the other core.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.conv_utils import conv_geometry, im2col
from repro_torch.kernels import _build
from repro_torch.kernels.bfp_matmul import (_INT_MAX, Out, _check_cuda,
                                            _check_wire, _finish_plain,
                                            _outputs, _pad_k, _ptr,
                                            _weights_inline, _weights_wire,
                                            check_epilogue, check_overflow,
                                            requant_plain, tiled_plain,
                                            wire_plain)

__all__ = ["bfp_conv2d", "bfp_conv2d_prequant", "bfp_conv2d_xprequant",
           "bfp_conv2d_xwprequant", "bfp_conv2d_xformat", "bfp_conv2d_plain",
           "bfp_conv2d_prequant_plain", "bfp_conv2d_xprequant_plain",
           "bfp_conv2d_xwprequant_plain", "bfp_conv2d_xformat_plain",
           "mma_core", "mma_tile", "conv_core", "MMA_TILES", "LAUNCHES"]

#: kernel launches per wrapper, incremented only where a kernel launches;
#: ``bfp_conv2d_epilogue`` counts those that ran the fused epilogue,
#: ``bfp_conv2d_xformat`` the activation format passes
LAUNCHES = {"bfp_conv2d": 0, "bfp_conv2d_prequant": 0,
            "bfp_conv2d_xprequant": 0, "bfp_conv2d_xwprequant": 0,
            "bfp_conv2d_epilogue": 0, "bfp_conv2d_xformat": 0}

#: the mma core's (rows, columns) tiles, largest first (``bfp_mma.cuh``
#: ``launch_conv``: tile index = position here)
MMA_TILES = ((64, 128), (32, 64), (32, 32), (16, 32))
#: the largest block the mma core stages (three stages fit 227 KB)
MMA_MAX_BK = 512
#: an H100's streaming multiprocessors: the tile whose grid reaches this
#: many blocks is taken
_SMS = 132
#: shared memory a block may use (bytes), and the core's layout of it:
#: three stages of x rows (+16 bytes), w rows (+4) and steps, and the
#: transposed w tile (``bfp_mma.cuh`` smem_bytes)
_SMEM = 232448


def _mma_smem(bm: int, bn: int, bk: int) -> int:
    return 3 * (bm * (bk + 16) + bk * (bn + 4) + 4 * (bm + bn)) + bn * bk


def mma_core(bk: int, c: int, n: int, out_bits: Optional[int],
             x_bits: Optional[int] = None) -> bool:
    """Does a weight-prequant conv run on the int8 mma core?  ``x_bits``
    is the L of an f32 x formatted here (None for a wire-format x, whose
    mantissas are int8 whatever its L).  A pure function of shape and
    policy: the epilogue, L > 8, a block that is not a power of two from
    32 to :data:`MMA_MAX_BK` dividing C, and an OC that 4-byte copies
    cannot tile stay on the tile kernel."""
    return (out_bits is None and (x_bits is None or x_bits <= 8)
            and 32 <= bk <= MMA_MAX_BK and bk & (bk - 1) == 0
            and c % bk == 0 and n % 4 == 0)


def mma_tile(m: int, n: int, bk: int) -> int:
    """Index into :data:`MMA_TILES`: the first tile whose grid fills the
    card's SMs, whose width is at most N (or 32) and whose shared memory
    fits, else the smallest.  A speed choice only: the bits do not depend
    on it."""
    for i, (bm, bn) in enumerate(MMA_TILES):
        if (bn <= max(n, 32) and _mma_smem(bm, bn, bk) <= _SMEM
                and -(-m // bm) * -(-n // bn) >= _SMS):
            return i
    return len(MMA_TILES) - 1


def conv_core(wire_x: bool, prequant_w: bool, bk: int, c: int, n: int,
              l_i: int, out_bits: Optional[int] = None) -> str:
    """"mma" or "tile": the core a conv call of this mode runs on."""
    if prequant_w and mma_core(bk, c, n, out_bits,
                               None if wire_x else l_i):
        return "mma"
    return "tile"


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


_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("bfp_conv")
        for fn, args in (
                (lib.bfp_conv_launch,
                 [ctypes.c_void_p] * 6 + [ctypes.c_int] * 19),
                (lib.bfp_conv_xformat_launch, [ctypes.c_void_p] * 3 + [
                    ctypes.c_longlong, ctypes.c_int, ctypes.c_int]),
                (lib.bfp_conv_mma_launch,
                 [ctypes.c_void_p] * 5 + [ctypes.c_int] * 14)):
            fn.argtypes = args + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its data starts on 16 bytes (the vector loads
    and 16-byte copies need it), else an aligned copy."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _on(dev: torch.device):
    """Make ``dev`` the current device for a launch (a no-op guard when
    it already is: the usual case, and the cheap one)."""
    return (contextlib.nullcontext() if torch._C._cuda_getDevice() == dev.index
            else torch.cuda.device(dev))


def _stream(dev: torch.device) -> int:
    """PyTorch's current stream on ``dev``, as the raw handle (no
    ``torch.cuda.Stream`` object is built per launch)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def _raise_on(rc: int, name: str) -> None:
    if rc:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


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


def _launch_mma(xm, xs, wm, ws, bk, stride, padding, name) -> torch.Tensor:
    """The int8 mma core on wire-format x and prequant w -> f32 NHWC."""
    b, h, wd, c = xm.shape
    kh, kw, _, oc = wm.shape
    oh, ow, (pt, _), (pl, _) = conv_geometry(h, wd, kh, kw, stride, padding)
    rows = b * oh * ow
    if max(rows, xm.numel(), kh * kw * c * oc) > _INT_MAX:
        raise ValueError(f"conv {tuple(xm.shape)} * {tuple(wm.shape)} "
                         f"exceeds the kernel's int32 indexing")
    xm, wm = _aligned(xm), _aligned(wm)
    dev = _check_cuda(xm, xs, wm, ws)
    out = torch.empty((b, oh, ow, oc), dtype=torch.float32, device=dev)
    if rows and oc:
        with _on(dev):
            _raise_on(_lib().bfp_conv_mma_launch(
                xm.data_ptr(), xs.data_ptr(), wm.data_ptr(), ws.data_ptr(),
                out.data_ptr(), b, h, wd, c, kh, kw, oc, stride, oh, ow, pt,
                pl, bk, mma_tile(rows, oc, bk), _stream(dev)), name)
        LAUNCHES[name] += 1
    return out


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
    if mma_core(bk, x.shape[3], wm_hwio.shape[3], out_bits, l_i):
        xm, xs = _launch_xformat(x, l_i, bk)
        return _launch_mma(xm, xs, wm_hwio.contiguous(),
                           ws.float().contiguous(), bk, stride, padding,
                           "bfp_conv2d_prequant")
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
    if mma_core(bk, xm.shape[3], wm_hwio.shape[3], out_bits):
        return _launch_mma(xm.contiguous(), xs.float().contiguous(),
                           wm_hwio.contiguous(), ws.float().contiguous(), bk,
                           stride, padding, "bfp_conv2d_xwprequant")
    return _launch(xm.contiguous(), xs.float().contiguous(),
                   wm_hwio.contiguous(), ws.float().contiguous(), l_i, l_w,
                   bk, stride, padding, out_bits, out_block,
                   "bfp_conv2d_xwprequant")
