"""Host side of the int8 ``mma.sync`` core (``csrc/bfp_mma.cuh``), shared
by the conv and matmul wrappers.

Which calls take the core (:func:`mma_core`, :func:`patch_core`), which
of its tiles a call runs (:func:`mma_tile`, or a tuned tile forced by
:func:`forced_tile`: :func:`pick_tile`), the patch-matrix geometry
of the inline route (:class:`_Patch`), the launches of the inline route
(:func:`_launch_patch`) and of the wire route (:func:`_launch_mma`: x on
the wire or formatted to it, w prequant or formatted by the weight
pass), and the handle of ``csrc/bfp_conv.cu``, which compiles the core
and both format passes.  A matmul is the 1x1,
stride-1, unpadded conv over x viewed as ``[1, B, 1, K]``, so
``kernels.bfp_conv`` and ``kernels.bfp_matmul`` both route through here
and neither imports the other for it.

The requantize epilogue (``out_bits``/``out_block``) takes the core where
the f32 call would: the call's f32 route writes the output to a scratch
tensor, and the activation format pass then formats it per (row,
``out_block`` chunk), the tile kernel's epilogue blocks and rules.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Dict, Optional

import torch

from repro_torch.core.conv_utils import conv_geometry
from repro_torch.kernels import _build

_INT_MAX = (1 << 31) - 1

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


def _mma_block(bk: int, n: int, out_bits: Optional[int],
               out_block: Optional[int]) -> bool:
    """What every call on the mma core needs: a block the core stages (a
    power of two from 32 to :data:`MMA_MAX_BK`) and an N that its 4-byte
    weight copies tile, in a grid the card launches; and an f32 output,
    or an epilogue the output format pass runs: int8 mantissas (2 <=
    ``out_bits`` <= 8) in blocks of a multiple of 4 floats (its 16-byte
    loads) that tile N."""
    epilogue = out_bits is None or (
        2 <= out_bits <= 8 and out_block is not None and out_block >= 4
        and out_block % 4 == 0 and n % out_block == 0)
    return (epilogue and 32 <= bk <= MMA_MAX_BK and bk & (bk - 1) == 0
            and n % 4 == 0 and -(-n // 32) <= 65535)


def mma_core(bk: int, c: int, n: int, out_bits: Optional[int],
             fmt_bits: Optional[int] = None,
             out_block: Optional[int] = None) -> bool:
    """Does a conv with x on the wire run on the int8 mma core?  That is
    the prequant conv (x formatted here), the x-prequant conv (w
    formatted here) and the xw-prequant conv.  ``fmt_bits`` is the L of
    the operand formatted here (None when both arrive on the wire, whose
    mantissas are int8 whatever their L).  A pure function of shape and
    policy: L > 8, a block that is not a power of two from 32 to
    :data:`MMA_MAX_BK` dividing C, an OC that 4-byte copies cannot tile
    and an epilogue the output pass cannot run stay on the tile kernel."""
    return (_mma_block(bk, n, out_bits, out_block)
            and (fmt_bits is None or fmt_bits <= 8) and c % bk == 0)


def patch_core(bk: int, n: int, out_bits: Optional[int], l_i: int,
               l_w: int, out_block: Optional[int] = None) -> bool:
    """Does an inline-weight conv run on the int8 mma core (after the
    patch format pass)?  As :func:`mma_core`, with both operands'
    mantissas int8 (L <= 8) and no condition on C: the patch blocks need
    not line up with channel chunks."""
    return _mma_block(bk, n, out_bits, out_block) and l_i <= 8 and l_w <= 8


#: the tile kernel's (rows, columns) tile, fixed at compile time
#: (``bfp_tile.cuh`` BM; BN, which is EPI_COLS with the epilogue)
TILE_KERNEL_TILE = (64, 64)
TILE_KERNEL_EPI_TILE = (64, 128)


def tile_kernel_tile(out_bits: Optional[int]) -> tuple:
    """The tile kernel's one tile, without or with the epilogue."""
    return TILE_KERNEL_TILE if out_bits is None else TILE_KERNEL_EPI_TILE


def tile_index(tile, bk: int) -> int:
    """The :data:`MMA_TILES` index of a (bm, bn) tile that the core can
    run at block ``bk`` (its stages fit in shared memory); anything else
    raises ``ValueError``."""
    tile = tuple(tile)
    if tile not in MMA_TILES:
        raise ValueError(f"tile {tile} is not one of the mma core's tiles "
                         f"MMA_TILES = {MMA_TILES}")
    if _mma_smem(*tile, bk) > _SMEM:
        raise ValueError(f"tile {tile} of MMA_TILES does not fit the mma "
                         f"core's shared memory at bk={bk}")
    return MMA_TILES.index(tile)


#: the MMA_TILES index forced on the calls inside :func:`forced_tile`
#: (``kernels.ops`` sets it from an explicit or tuned tile), else None
_FORCED: Optional[int] = None


@contextlib.contextmanager
def forced_tile(index: Optional[int]):
    """Run the mma core's launches inside on tile ``index`` instead of
    :func:`mma_tile`'s choice (None: the rule chooses).  The bits do not
    depend on the tile."""
    global _FORCED
    prev, _FORCED = _FORCED, index
    try:
        yield
    finally:
        _FORCED = prev


def pick_tile(m: int, n: int, bk: int) -> int:
    """The tile a launch runs: the forced one, else :func:`mma_tile`'s."""
    return mma_tile(m, n, bk) if _FORCED is None else _FORCED


@functools.lru_cache(maxsize=1024)
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


_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    """``csrc/bfp_conv.cu``: both conv cores, both format passes and the
    matmul's route through the mma core."""
    global _LIB
    if _LIB is None:
        lib = _build.load("bfp_conv")
        for fn, args in (
                (lib.bfp_conv_launch,
                 [ctypes.c_void_p] * 6 + [ctypes.c_int] * 19),
                (lib.bfp_conv_xformat_launch, [ctypes.c_void_p] * 3 + [
                    ctypes.c_longlong, ctypes.c_int, ctypes.c_int]),
                (lib.bfp_conv_pformat_launch,
                 [ctypes.c_void_p] * 6 + [ctypes.c_int] * 17),
                (lib.bfp_conv_patch_launch,
                 [ctypes.c_void_p] * 9 + [ctypes.c_int] * 20),
                (lib.bfp_conv_mma_launch,
                 [ctypes.c_void_p] * 9 + [ctypes.c_int] * 18),
                (lib.bfp_matmul_mma_launch,
                 [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8)):
            fn.argtypes = args + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check_cuda(*tensors: Optional[torch.Tensor]) -> torch.device:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"the kernels take CUDA tensors (CPU tensors run "
                         f"the plain version), got {dev}")
    for t in tensors:
        if t is not None and t.device != dev:
            raise ValueError(f"operands on different devices: {t.device} "
                             f"vs {dev}")
        if t is not None and not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
    return dev


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


def _outputs(shape, out_bits: Optional[int], out_block: Optional[int],
             dev: torch.device):
    """Kernel outputs: f32 ``shape``, or int8 ``shape`` + f32 steps with
    the last axis cut into ``out_block`` chunks."""
    if out_bits is None:
        return torch.empty(shape, dtype=torch.float32, device=dev), None
    return (torch.empty(shape, dtype=torch.int8, device=dev),
            torch.empty((*shape[:-1], shape[-1] // out_block),
                        dtype=torch.float32, device=dev))


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _count(counters: Dict[str, int], family: str, core: str,
           out_bits: Optional[int], *passes: str, layer: bool = True) -> None:
    """One host call on the mma core: the core under ``core``, each
    format pass it issued under ``family + pass``, and with ``out_bits``
    the output pass under ``family + "_oformat"``.  ``layer``: the call is
    the layer's first, so with ``out_bits`` the layer also counts under
    ``family + "_epilogue"`` (once per layer, however its rows are
    chunked)."""
    counters[core] += 1
    for p in passes:
        counters[family + p] += 1
    if out_bits is not None:
        counters[family + "_oformat"] += 1
        counters[family + "_epilogue"] += int(layer)


class _Patch:
    """Geometry of an inline conv's patch matrix [M, Kp] and the byte
    offsets of the format pass's outputs in one workspace of ``nbytes``
    that holds ``rows`` patch rows (the route through the core): x
    mantissas [rows, Kp], x steps [rows, n_k], w mantissas [Kp, OC], w
    steps [n_k, OC], each on 16 bytes.  ``chunked``: rows * Kp stays
    within the int32 indexing of the format pass and the core (else
    rows = M).  Built through :func:`_patch`, once per shape: a served
    layer pays no Python for it after its first call."""

    def __init__(self, x_shape, w_shape, bk: int, stride: int, padding: str,
                 chunked: bool = False):
        b, h, wd, c = x_shape
        kh, kw, _, oc = w_shape
        oh, ow, (pt, _), (pl, _) = conv_geometry(h, wd, kh, kw, stride,
                                                 padding)
        self.m, self.n_k = b * oh * ow, -(-kh * kw * c // bk)
        self.kp = self.n_k * bk
        self.out_shape = (b, oh, ow, oc)
        self.dims = (h, wd, c, kh, kw, oc, stride, oh, ow, pt, pl)
        self.rows = min(self.m, _INT_MAX // self.kp) if chunked else self.m
        offsets, off = [], 0
        for size in (self.rows * self.kp, 4 * self.rows * self.n_k,
                     self.kp * oc, 4 * self.n_k * oc):
            offsets.append(off)
            off += -(-size // 16) * 16
        self.offsets, self.nbytes = tuple(offsets), off

    def check(self, x: torch.Tensor) -> None:
        """The format pass's and the core's indices are 32-bit."""
        if max(x.numel(), self.rows * self.kp,
               self.kp * self.out_shape[3]) > _INT_MAX:
            raise ValueError(f"conv {tuple(x.shape)} -> "
                             f"{self.out_shape} exceeds the kernels' int32 "
                             f"indexing")


@functools.lru_cache(maxsize=1024)
def _patch(x_shape, w_shape, bk: int, stride: int, padding: str,
           chunked: bool) -> _Patch:
    return _Patch(x_shape, w_shape, bk, stride, padding, chunked)


def _launch_patch(x: torch.Tensor, w: torch.Tensor, l_i: int, l_w: int,
                  bk: int, stride: int, padding: str,
                  counters: Dict[str, int], family: str,
                  out_bits: Optional[int] = None,
                  out_block: Optional[int] = None, layer: bool = True):
    """An inline conv on the mma core: per chunk of patch rows, one host
    call that launches the patch format pass (the weight too in the first
    chunk), the core as a 1x1 conv over the chunk's patch matrix
    [1, rows, 1, Kp] -> f32 NHWC and, with ``out_bits``, the output
    format pass over the chunk's rows (the f32 output is then scratch and
    the wire pair is returned).  Rows are chunked only where rows * Kp
    would pass the int32 indexing (never at the served batch of 8).  Each
    host call counts under ``family`` (``bfp_conv2d`` or ``bfp_matmul``):
    the core, ``_pformat`` and, with the epilogue, ``_oformat``; the
    layer counts once under ``_epilogue`` unless ``layer`` is False (a
    later row block of one matmul)."""
    x, w = _aligned(x.float().contiguous()), w.float().contiguous()
    geo = _patch(x.shape, w.shape, bk, stride, padding, True)
    geo.check(x)
    dev = _check_cuda(x, w)
    out = torch.empty(geo.out_shape, dtype=torch.float32, device=dev)
    om, os_ = (None, None) if out_bits is None else _outputs(
        geo.out_shape, out_bits, out_block, dev)
    oc = geo.out_shape[3]
    if geo.m and oc:
        ws = torch.empty(geo.nbytes, dtype=torch.uint8, device=dev)
        ptrs = [ws.data_ptr() + o for o in geo.offsets]
        with _on(dev):
            for row0 in range(0, geo.m, geo.rows):
                rows = min(geo.rows, geo.m - row0)
                _raise_on(_lib().bfp_conv_patch_launch(
                    x.data_ptr(), w.data_ptr(), *ptrs, out.data_ptr(),
                    _ptr(om), _ptr(os_), row0, rows, int(row0 == 0),
                    *geo.dims, bk, l_i, l_w, out_bits or 0, out_block or 0,
                    pick_tile(rows, oc, bk), _stream(dev)), family)
                _count(counters, family, family, out_bits, "_pformat",
                       layer=layer and row0 == 0)
    return out if out_bits is None else (om, os_)


def _launch_mma(xm, xs, wm, ws, bk: int, stride: int, padding: str,
                counters: Dict[str, int], family: str, name: str, *,
                x=None, w=None, l_i: int = 8, l_w: int = 8,
                out_bits: Optional[int] = None,
                out_block: Optional[int] = None, layer: bool = True):
    """The int8 mma core on wire-format x and w -> f32 NHWC, with the
    passes of ``bfp_conv_mma_launch`` around it in the same host call:
    an f32 NHWC ``x`` (for None ``xm``/``xs``) is formatted into scratch
    first (L = ``l_i``), a float HWIO ``w`` (for None ``wm``/``ws``) into
    a scratch sidecar [K, OC] + [K // bk, OC] (L = ``l_w``), and with
    ``out_bits`` the f32 output (then scratch) is formatted into the
    returned wire pair.  A matmul passes x as ``[1, B, 1, K]`` and w as
    ``[1, 1, K, N]`` (stride 1, VALID).  The call counts under ``family``
    (``bfp_conv2d`` or ``bfp_matmul``): the core under ``name``, its
    passes and, with ``out_bits``, the layer under ``_epilogue`` unless
    ``layer`` is False (a later row block of one matmul)."""
    b, h, wd, c = (xm if x is None else x).shape
    kh, kw, _, oc = (wm if w is None else w).shape
    oh, ow, (pt, _), (pl, _) = conv_geometry(h, wd, kh, kw, stride, padding)
    rows, k = b * oh * ow, kh * kw * c
    if max(rows, b * h * wd * c, k * oc) > _INT_MAX:
        raise ValueError(f"conv {(b, h, wd, c)} * {(kh, kw, c, oc)} "
                         f"exceeds the kernel's int32 indexing")
    passes = ()
    if x is None:
        xm = _aligned(xm)
    else:
        x = _aligned(x.float().contiguous())
        xm = torch.empty(x.shape, dtype=torch.int8, device=x.device)
        xs = torch.empty((b, h, wd, c // bk), dtype=torch.float32,
                         device=x.device)
        passes = ("_xformat",)
    if w is None:
        wm = _aligned(wm)
    else:
        w = w.float().contiguous()
        wm = torch.empty((k, oc), dtype=torch.int8, device=w.device)
        ws = torch.empty((k // bk, oc), dtype=torch.float32, device=w.device)
        passes = ("_wformat",)
    dev = _check_cuda(xm, xs, wm, ws, x, w)
    out = torch.empty((b, oh, ow, oc), dtype=torch.float32, device=dev)
    om, os_ = (None, None) if out_bits is None else _outputs(
        out.shape, out_bits, out_block, dev)
    if rows and oc:
        with _on(dev):
            _raise_on(_lib().bfp_conv_mma_launch(
                _ptr(x), _ptr(w), xm.data_ptr(), xs.data_ptr(),
                wm.data_ptr(), ws.data_ptr(), out.data_ptr(), _ptr(om),
                _ptr(os_), b, h, wd, c, kh, kw, oc, stride, oh, ow, pt, pl,
                bk, l_i, l_w, out_bits or 0, out_block or 0,
                pick_tile(rows, oc, bk), _stream(dev)), name)
        _count(counters, family, name, out_bits, *passes, layer=layer)
    return out if out_bits is None else (om, os_)


def _by_rows(launch, m: int, rows: int, out_bits: Optional[int]):
    """``launch(r0, r1, layer)`` on each block of ``rows`` rows of an
    M-row matmul, the outputs joined: where a call's indexing would pass
    int32 (never when served).  ``layer`` is True for the first block
    only, so the layer's epilogue counts once."""
    parts = [launch(r0, min(r0 + rows, m), r0 == 0)
             for r0 in range(0, m, rows)]
    if out_bits is None:
        return torch.cat(parts)
    return tuple(torch.cat(p) for p in zip(*parts))
