"""Fused BFP matmul: CUDA kernel wrappers and their plain PyTorch versions.

Counterpart of ``repro.kernels.bfp_matmul`` (``bfp_matmul_pallas``,
``bfp_matmul_prequant_pallas``, ``bfp_matmul_xprequant_pallas`` and
``bfp_matmul_xwprequant_pallas``).  Per K-tile of ``bk`` (the BFP block):
block-format x per row and w per column — or take an operand's int8
mantissas and f32 steps as given (the wire format) — exact integer tile
dot, then ``acc = acc + part * (sx * sw)`` in f32, tiles in order
0 .. n_k-1.  With ``out_bits`` set, the requantize epilogue block-formats
the f32 accumulator per (row, ``out_block`` column chunk) and returns
``(int8 mantissas [B, N], f32 steps [B, N // out_block])`` instead.

A wrapper given CPU tensors runs the plain version; given CUDA tensors
it launches a kernel or raises — there is no fallback from one to the
other, nor from one core to the other.  Two cores, chosen by
:func:`matmul_core` (a pure function of shape and policy):

* the int8 ``mma.sync`` core of the convs (``csrc/bfp_mma.cuh``, built
  into ``csrc/bfp_conv.cu``) takes the matmuls that it can run as the
  1x1, stride-1, unpadded conv over x viewed as ``[1, B, 1, K]`` and w
  as ``[1, 1, K, N]``: a (row, K-tile) block of the matmul is a (pixel,
  channel chunk) block of that conv, and the weight sidecar
  ``[K // bk, N]`` has the same layout in both.  ``bfp_matmul_prequant``
  runs the conv's activation format pass and then the core, from one
  host call; ``bfp_matmul`` (float weights) the inline conv's patch
  format pass and then the core; ``bfp_matmul_xprequant`` (wire x, float
  weights) the x-prequant conv's route: the weight format pass (the
  patch pass's weight blocks alone, once per call) and then the core on
  the wire x; ``bfp_matmul_xwprequant`` (both operands on the wire) the
  xw-prequant conv's route: the core alone, no format pass.  With
  ``out_bits`` (an ``out_block`` that is a multiple of 4) the output
  format pass follows in the same host call: the activation format pass
  over the f32 output in ``out_block`` chunks, the requantize epilogue;
* the tile kernel (``csrc/bfp_matmul.cu``) takes the rest: L > 8 where
  an operand is formatted here, blocks that are not a power of two from
  32 to 512, N % 4 != 0 and an ``out_block`` of 1 or 2.

The outputs are bit-identical on both.  ``LAUNCHES`` counts kernel
launches per wrapper (a core launch under the wrapper's own name), under
``bfp_matmul_epilogue`` the calls that ran the requantize epilogue, under
``bfp_matmul_xformat`` the activation format passes, under
``bfp_matmul_pformat`` the patch format passes, under
``bfp_matmul_wformat`` the weight format passes and under
``bfp_matmul_oformat`` the output format passes.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core.bfp import ZERO_BLOCK_EXP, pow2
from repro_torch.kernels import _build, _mma
from repro_torch.kernels._mma import (_INT_MAX, _check_cuda, _outputs,
                                      _ptr, mma_core, patch_core)

__all__ = ["bfp_matmul", "bfp_matmul_prequant", "bfp_matmul_xprequant",
           "bfp_matmul_xwprequant", "bfp_matmul_plain",
           "bfp_matmul_prequant_plain", "bfp_matmul_xprequant_plain",
           "bfp_matmul_xwprequant_plain", "requant_plain", "check_overflow",
           "check_epilogue", "matmul_core", "f32_dot_exact",
           "resolve_dot_impl", "EPILOGUE_COLS", "LAUNCHES"]

#: kernel launches per wrapper, incremented only where a kernel launches;
#: ``bfp_matmul_epilogue`` counts the calls that ran the requantize
#: epilogue, ``bfp_matmul_xformat`` the activation format passes,
#: ``bfp_matmul_pformat`` the patch format passes, ``bfp_matmul_wformat``
#: the weight format passes and ``bfp_matmul_oformat`` the output format
#: passes of the mma core's routes
LAUNCHES = {"bfp_matmul": 0, "bfp_matmul_prequant": 0,
            "bfp_matmul_xprequant": 0, "bfp_matmul_xwprequant": 0,
            "bfp_matmul_epilogue": 0, "bfp_matmul_xformat": 0,
            "bfp_matmul_pformat": 0, "bfp_matmul_wformat": 0,
            "bfp_matmul_oformat": 0}

#: the column tile of the tile kernel's epilogue (``bfp_tile.cuh``
#: EPI_COLS): an epilogue block must divide it, so each block lies in one
#: thread block (repro's ops hold the fused epilogue to the same rule)
EPILOGUE_COLS = 128

#: f32 holds every integer of magnitude <= 2^24 exactly
_F32_EXACT_BOUND = 1 << 24

#: f32 output, or the epilogue's (int8 mantissas, f32 steps)
Out = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def check_overflow(bk: int, l_sum: int) -> None:
    """Paper Fig. 2 accumulator sizing: int32 must hold ``bk`` products
    of L_I- and L_W-bit mantissas (``l_sum = L_I + L_W``)."""
    if bk < 1:
        raise ValueError(f"bk={bk} must be >= 1")
    if l_sum + math.ceil(math.log2(bk)) > 32:
        raise ValueError(f"bk={bk} overflows int32 for L_I+L_W={l_sum}")


def check_epilogue(out_bits: Optional[int], out_block: Optional[int],
                   n: int) -> None:
    """The epilogue emits int8 mantissas (2 <= out_bits <= 8) in blocks
    that tile N and lie inside one column tile of the kernel."""
    if out_bits is None:
        return
    if not 2 <= out_bits <= 8:
        raise ValueError(f"epilogue out_bits={out_bits} must be 2..8 "
                         f"(int8 mantissa wire format)")
    if out_block is None or out_block < 1 or n % out_block or \
            EPILOGUE_COLS % out_block:
        raise ValueError(f"epilogue out_block={out_block} must divide "
                         f"N={n} and the {EPILOGUE_COLS}-column tile")


def matmul_core(prequant_w: bool, bk: int, k: int, n: int, l_i: int,
                l_w: int, out_bits: Optional[int] = None,
                out_block: Optional[int] = None,
                wire_x: bool = False) -> str:
    """"mma" or "tile": the core a matmul takes (``wire_x``: x arrives in
    the wire format).  As the 1x1 conv over ``[1, B, 1, K]``: f32 x with
    prequant weights takes the mma core where the prequant conv does
    (``_mma.mma_core``, C = K), f32 x with float weights where the inline
    conv does (``_mma.patch_core``), wire x with float weights where the
    x-prequant conv does (``_mma.mma_core`` with the weight's L, bk | K),
    and both operands on the wire where the xw-prequant conv does
    (``_mma.mma_core`` with no L: wire mantissas are int8 whatever their
    L), the epilogue included; each needs Kp * N within the core's int32
    indexing (Kp: K rounded up to a ``bk`` multiple).  B sets no
    condition: past 2^31 elements x is cut into row blocks."""
    kp = -(-k // bk) * bk
    if k < 1 or kp * n > _INT_MAX:
        return "tile"
    if wire_x:
        on_mma = mma_core(bk, k, n, out_bits, None if prequant_w else l_w,
                          out_block)
    elif prequant_w:
        on_mma = mma_core(bk, k, n, out_bits, l_i, out_block)
    else:
        on_mma = patch_core(bk, n, out_bits, l_i, l_w, out_block)
    return "mma" if on_mma else "tile"


def _check_wire(m: torch.Tensor, what: str) -> None:
    if m.dtype != torch.int8:
        raise ValueError(f"{what} kernel streams int8 mantissas, got "
                         f"{m.dtype}")


def _floor_log2(amax: torch.Tensor) -> torch.Tensor:
    """floor(log2 x), x >= 0, from the float32 exponent field (a
    subnormal amax gives -127, as in the Pallas kernels)."""
    bits = amax.contiguous().view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 127
    return torch.where(amax > 0, e, torch.full_like(e, ZERO_BLOCK_EXP))


def block_format(tile: torch.Tensor, bits: int,
                 dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-format ``tile`` along ``dim`` -> (integer-valued f32
    mantissas, f32 steps with a keepdim 1 on ``dim``).  Blocks whose
    amax is not > 0 (all zero, or holding a NaN) get mantissa 0."""
    amax = tile.abs().amax(dim=dim, keepdim=True)
    step = pow2(_floor_log2(amax) - (bits - 2))
    lim = float(2 ** (bits - 1) - 1)
    m = torch.clamp(torch.round(tile / step), -lim, lim)
    return torch.where(amax > 0, m, torch.zeros_like(m)), step


def requant_plain(out: torch.Tensor, bits: int,
                  block: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the requantize epilogue: ``out [.., N]`` f32 ->
    (int8 mantissas [.., N], f32 steps [.., N // block]), one block per
    (row, ``block`` chunk of the last axis), the kernels' block rules
    (repro's ``_requant_store``).  Equal to ``core.prequant.prequant_act``
    wherever a block's amax is a normal float; they part on a NaN, inf or
    subnormal amax, which ``prequant_act`` reads through frexp."""
    lead, n = out.shape[:-1], out.shape[-1]
    m, step = block_format(out.reshape(*lead, n // block, block), bits, -1)
    return (m.to(torch.int8).reshape(*lead, n),
            step.reshape(*lead, n // block))


def f32_dot_exact(l_i: int, l_w: int, bk: int) -> bool:
    """True when an f32 dot over ``bk``-long int-mantissa products is
    bit-identical to int32 accumulation: every product and partial sum
    is an integer of magnitude <= 2^24 (``repro``'s predicate)."""
    return bk * (2 ** (l_i - 1) - 1) * (2 ** (l_w - 1) - 1) \
        <= _F32_EXACT_BOUND


def resolve_dot_impl(dot_impl: str, *, l_i: int, l_w: int, bk: int,
                     interpret: bool, x_pq: bool = False,
                     w_pq: bool = False) -> str:
    """``repro``'s dot-mode rule: resolve ``"auto"`` and validate an
    explicit ``"int8"`` / ``"int32"`` / ``"f32"``, raising where
    ``repro``'s raises (``"int8"`` with an inline L > 8, ``"f32"`` past
    the 2^24 bound, an unknown name).  Wire operands arrive as int8
    mantissas, so their L never forces int32.  ``repro`` pins every mode
    bit-identical; the port runs one datapath per core whatever the mode,
    so ``kernels.ops`` only validates it here."""
    li_eff = min(l_i, 8) if x_pq else l_i
    lw_eff = min(l_w, 8) if w_pq else l_w
    if dot_impl == "auto":
        if max(li_eff, lw_eff) > 8:
            return "int32"
        if interpret:
            return "f32" if f32_dot_exact(li_eff, lw_eff, bk) else "int32"
        return "int8"
    if dot_impl == "int8" and max(li_eff, lw_eff) > 8:
        raise ValueError(f"dot_impl='int8' needs inline L <= 8, got "
                         f"L_I={l_i}, L_W={l_w}")
    if dot_impl == "f32" and not f32_dot_exact(li_eff, lw_eff, bk):
        raise ValueError(f"dot_impl='f32' not exact for L_I={l_i}, "
                         f"L_W={l_w}, bk={bk} (bound 2^24)")
    if dot_impl not in ("int8", "int32", "f32"):
        raise ValueError(f"unknown dot_impl {dot_impl!r}")
    return dot_impl


#: Most partials :func:`accumulate_plain` forms at once ([tiles, B, N]).
PART_ELEMS = 1 << 27


def _tile_dots(mx: torch.Tensor, mw: torch.Tensor, l_i: int, l_w: int,
               bk: int) -> torch.Tensor:
    """[n_k, B, bk] @ [n_k, bk, N] integer mantissas -> exact partials,
    rounded once to f32.  An f32 product is exact while every partial
    sum stays within 2^24 (and TF32 is off); beyond that f64 is exact
    for any tile the int32 overflow guard admits."""
    if f32_dot_exact(l_i, l_w, bk):
        return torch.matmul(mx, mw)
    return torch.matmul(mx.double(), mw.double()).float()


def accumulate_plain(mx: torch.Tensor, sx: torch.Tensor, mw: torch.Tensor,
                     sw: torch.Tensor, l_i: int, l_w: int,
                     bk: int) -> torch.Tensor:
    """The shared plain datapath after block formatting: mantissas mx
    [n_k, B, bk] and mw [n_k, bk, N], steps sx [n_k, B, 1] and sw
    [n_k, 1, N] -> f32 [B, N], tiles accumulated in order.  The tiles'
    partials are formed :data:`PART_ELEMS` elements at a time (a long
    contraction at a small block has more tiles than a card holds
    partials)."""
    n_k, b, n = mx.shape[0], mx.shape[1], mw.shape[-1]
    step = max(1, PART_ELEMS // max(1, b * n))
    out = torch.zeros((b, n), dtype=torch.float32, device=mx.device)
    for t0 in range(0, n_k, step):
        part = _tile_dots(mx[t0:t0 + step], mw[t0:t0 + step], l_i, l_w, bk)
        for t in range(part.shape[0]):
            out = out + part[t] * (sx[t0 + t] * sw[t0 + t])
    return out


def tiled_plain(x: torch.Tensor, mw: torch.Tensor, sw: torch.Tensor,
                l_i: int, l_w: int, bk: int) -> torch.Tensor:
    """x [B, n_k*bk] f32 (zero K-padding) block-formatted per (row,
    K-tile), then :func:`accumulate_plain` with the weight mantissas mw
    [n_k, bk, N] and steps sw [n_k, 1, N]."""
    xt = x.reshape(x.shape[0], mw.shape[0], bk).transpose(0, 1)
    mx, sx = block_format(xt, l_i, dim=2)                 # sx [n_k, B, 1]
    return accumulate_plain(mx, sx, mw, sw, l_i, l_w, bk)


def wire_plain(xm: torch.Tensor, xs: torch.Tensor, mw: torch.Tensor,
               sw: torch.Tensor, l_w: int, bk: int) -> torch.Tensor:
    """:func:`accumulate_plain` on wire-format x: int8 mantissas xm
    [B, n_k*bk] and steps xs [B, n_k] taken as given."""
    b, n_k = xs.shape
    mx = xm.float().reshape(b, n_k, bk).transpose(0, 1)
    sx = xs.float().t().reshape(n_k, b, 1)
    return accumulate_plain(mx, sx, mw, sw, 8, l_w, bk)


def _pad_k(a: torch.Tensor, kp: int, dim: int) -> torch.Tensor:
    k = a.shape[dim]
    if k == kp:
        return a
    pad = [0, 0] * (a.ndim - 1 - dim) + [0, kp - k]
    return F.pad(a, pad)


def _weights_inline(w: torch.Tensor, l_w: int, bk: int):
    """Float w [K, N] zero-padded to a ``bk`` multiple and block-formatted
    per (column, K-tile) -> (mw [n_k, bk, N], sw [n_k, 1, N])."""
    k, n = w.shape
    kp = -(-k // bk) * bk
    wt = _pad_k(w.float(), kp, 0).reshape(kp // bk, bk, n)
    return block_format(wt, l_w, dim=1)


def _weights_wire(wm: torch.Tensor, ws: torch.Tensor, bk: int):
    k, n = wm.shape
    return (wm.float().reshape(k // bk, bk, n),
            ws.float().reshape(k // bk, 1, n))


def _finish_plain(out: torch.Tensor, out_bits, out_block) -> Out:
    return out if out_bits is None else requant_plain(out, out_bits,
                                                      out_block)


def bfp_matmul_plain(x: torch.Tensor, w: torch.Tensor, l_i: int, l_w: int,
                     bk: int, out_bits: Optional[int] = None,
                     out_block: Optional[int] = None) -> Out:
    """Plain version of the inline kernel; K zero-pads to a ``bk``
    multiple (inert: no block amax changes, zero products)."""
    mw, sw = _weights_inline(w, l_w, bk)
    out = tiled_plain(_pad_k(x.float(), mw.shape[0] * bk, 1), mw, sw, l_i,
                      l_w, bk)
    return _finish_plain(out, out_bits, out_block)


def bfp_matmul_prequant_plain(x: torch.Tensor, wm: torch.Tensor,
                              ws: torch.Tensor, l_i: int, l_w: int, bk: int,
                              out_bits: Optional[int] = None,
                              out_block: Optional[int] = None) -> Out:
    """Plain version of the prequant kernel: ``wm`` int8 [K, N], ``ws``
    f32 steps [K//bk, N], K a ``bk`` multiple."""
    mw, sw = _weights_wire(wm, ws, bk)
    out = tiled_plain(x.float(), mw, sw, l_i, min(l_w, 8), bk)
    return _finish_plain(out, out_bits, out_block)


def bfp_matmul_xprequant_plain(xm: torch.Tensor, xs: torch.Tensor,
                               w: torch.Tensor, l_i: int, l_w: int, bk: int,
                               out_bits: Optional[int] = None,
                               out_block: Optional[int] = None) -> Out:
    """Plain version of the x-prequant kernel: ``xm`` int8 [B, K], ``xs``
    f32 steps [B, K//bk], float ``w`` quantized per (column, K-tile)."""
    mw, sw = _weights_inline(w, l_w, bk)
    return _finish_plain(wire_plain(xm, xs, mw, sw, l_w, bk), out_bits,
                         out_block)


def bfp_matmul_xwprequant_plain(xm: torch.Tensor, xs: torch.Tensor,
                                wm: torch.Tensor, ws: torch.Tensor, l_i: int,
                                l_w: int, bk: int,
                                out_bits: Optional[int] = None,
                                out_block: Optional[int] = None) -> Out:
    """Plain version of the kernel with both operands on the wire."""
    mw, sw = _weights_wire(wm, ws, bk)
    return _finish_plain(wire_plain(xm, xs, mw, sw, 8, bk), out_bits,
                         out_block)


# ---------------------------------------------------------------------------
# CUDA launch
# ---------------------------------------------------------------------------

def _lib() -> ctypes.CDLL:
    lib = _build.load("bfp_matmul")
    fn = lib.bfp_matmul_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _launch(x, xs, w, ws, l_i, l_w, bk, out_bits, out_block, name) -> Out:
    m, k = x.shape
    n = w.shape[1]
    if max(m, n, k) > _INT_MAX or -(-n // 64) > 65535:
        raise ValueError(f"shape ({m},{k})x({k},{n}) exceeds the kernel's "
                         f"int32 indexing / grid")
    dev = _check_cuda(x, xs, w, ws)
    out, out_s = _outputs((m, n), out_bits, out_block, dev)
    if m and n:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = _lib().bfp_matmul_launch(
                x.data_ptr(), _ptr(xs), w.data_ptr(), _ptr(ws),
                out.data_ptr(), _ptr(out_s), m, n, k, bk, l_i, l_w,
                int(xs is not None), int(ws is not None), out_bits or 0,
                out_block or 0, stream)
        if rc:
            raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                               f"{rc}")
        LAUNCHES[name] += 1
        if out_bits is not None:
            LAUNCHES["bfp_matmul_epilogue"] += 1
    return out if out_bits is None else (out, out_s)


def _launch_mma(x: torch.Tensor, wm: torch.Tensor, ws: torch.Tensor,
                l_i: int, bk: int, out_bits: Optional[int] = None,
                out_block: Optional[int] = None) -> Out:
    """The prequant matmul on the mma core: per block of rows, one host
    call that launches the activation format pass (x per (row, K-tile)
    into a workspace of int8 mantissas and f32 steps), the core as the
    1x1 conv over ``[1, rows, 1, K]`` and, with ``out_bits``, the output
    format pass over those rows (the f32 output is then scratch).  Rows
    are cut into blocks only where rows * K would pass the int32
    indexing (never when served)."""
    x = _mma._aligned(x.float().contiguous())
    wm, ws = _mma._aligned(wm.contiguous()), ws.float().contiguous()
    dev = _check_cuda(x, wm, ws)
    m, k = x.shape
    n = wm.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    om, os_ = (None, None) if out_bits is None else _outputs(
        (m, n), out_bits, out_block, dev)
    if m and n:
        rows = min(m, _INT_MAX // k)
        xs_at = -(-rows * k // 16) * 16
        buf = torch.empty(xs_at + 4 * rows * (k // bk), dtype=torch.uint8,
                          device=dev)
        n_ob = n // out_block if out_bits is not None else 0
        with _mma._on(dev):
            for row0 in range(0, m, rows):
                r = min(rows, m - row0)
                _mma._raise_on(_mma._lib().bfp_matmul_mma_launch(
                    x.data_ptr() + 4 * row0 * k, wm.data_ptr(),
                    ws.data_ptr(), buf.data_ptr(), buf.data_ptr() + xs_at,
                    out.data_ptr() + 4 * row0 * n,
                    om.data_ptr() + row0 * n if om is not None else None,
                    os_.data_ptr() + 4 * row0 * n_ob if om is not None
                    else None, r, n, k, bk, l_i, out_bits or 0,
                    out_block or 0, _mma.pick_tile(r, n, bk),
                    _mma._stream(dev)), "bfp_matmul_prequant")
                _mma._count(LAUNCHES, "bfp_matmul", "bfp_matmul_prequant",
                            out_bits, "_xformat", layer=row0 == 0)
    return out if out_bits is None else (om, os_)


def _launch_patch(x: torch.Tensor, w: torch.Tensor, l_i: int, l_w: int,
                  bk: int, out_bits: Optional[int] = None,
                  out_block: Optional[int] = None, layer: bool = True) -> Out:
    """The inline matmul on the mma core: the inline conv's route (patch
    format pass, the core and with ``out_bits`` the output format pass;
    one host call) over x viewed as ``[1, B, 1, K]`` and w as
    ``[1, 1, K, N]``, stride 1, VALID.  The pass indexes x with 32 bits,
    so an x of more than 2^31 elements runs as row blocks, each its own
    1x1 conv (never when served)."""
    m, k = x.shape
    n = w.shape[1]
    rows = _INT_MAX // (-(-k // bk) * bk)
    if m > rows:
        return _mma._by_rows(lambda r0, r1, first: _launch_patch(
            x[r0:r1], w, l_i, l_w, bk, out_bits, out_block, layer and first),
            m, rows, out_bits)
    return _as_matmul(_mma._launch_patch(
        x.reshape(1, m, 1, k), w.reshape(1, 1, k, n), l_i, l_w, bk, 1,
        "VALID", LAUNCHES, "bfp_matmul", out_bits, out_block, layer), m, n,
        out_block)


def _as_matmul(out, m: int, n: int, out_block: Optional[int]) -> Out:
    """A 1x1 conv's output over ``[1, M, 1, N]`` (f32, or the wire pair)
    as the matmul's ``[M, N]``."""
    if isinstance(out, torch.Tensor):
        return out.reshape(m, n)
    return out[0].reshape(m, n), out[1].reshape(m, n // out_block)


def _launch_wire(xm: torch.Tensor, xs: torch.Tensor, w: torch.Tensor,
                 ws: Optional[torch.Tensor], l_w: int, bk: int,
                 out_bits: Optional[int] = None,
                 out_block: Optional[int] = None, layer: bool = True) -> Out:
    """A wire-x matmul on the mma core, as the wire conv's route over x
    viewed as ``[1, B, 1, K]`` with steps ``[1, B, 1, K // bk]`` and w
    as ``[1, 1, K, N]``, stride 1, VALID, in one host call: with a float
    ``w`` (``ws`` None: the x-prequant matmul) the weight format pass
    first, with int8 mantissas ``w`` and steps ``ws [K // bk, N]`` (the
    xw-prequant matmul) no pass; then the core on the wire x and, with
    ``out_bits``, the output format pass.  An x of more than 2^31
    elements runs as row blocks, each its own call (never when
    served)."""
    m, k = xm.shape
    n = w.shape[1]
    rows = _INT_MAX // k
    if m > rows:
        return _mma._by_rows(lambda r0, r1, first: _launch_wire(
            xm[r0:r1], xs[r0:r1], w, ws, l_w, bk, out_bits, out_block,
            layer and first), m, rows, out_bits)
    w4 = w.contiguous().reshape(1, 1, k, n)
    pre = ws is not None
    return _as_matmul(_mma._launch_mma(
        xm.contiguous().reshape(1, m, 1, k),
        xs.float().contiguous().reshape(1, m, 1, k // bk),
        w4 if pre else None, ws.float().contiguous() if pre else None, bk,
        1, "VALID", LAUNCHES, "bfp_matmul",
        "bfp_matmul_xwprequant" if pre else "bfp_matmul_xprequant",
        w=None if pre else w4, l_w=l_w, out_bits=out_bits,
        out_block=out_block, layer=layer), m, n, out_block)


def _check_operands(x_shape, w_shape, bk, xs=None, ws=None) -> None:
    b, k = x_shape
    k2, n = w_shape
    if k != k2:
        raise ValueError(f"contraction mismatch {tuple(x_shape)} @ "
                         f"{tuple(w_shape)}")
    if xs is not None and (k % bk or tuple(xs.shape) != (b, k // bk)):
        raise ValueError(f"activation sidecar {tuple(xs.shape)} != "
                         f"{(b, k // bk)} for bk={bk}")
    if ws is not None and (k % bk or tuple(ws.shape) != (k // bk, n)):
        raise ValueError(f"scale sidecar {tuple(ws.shape)} != "
                         f"{(k // bk, n)} for bk={bk}")


def bfp_matmul(x: torch.Tensor, w: torch.Tensor, *, l_i: int, l_w: int,
               bk: int, out_bits: Optional[int] = None,
               out_block: Optional[int] = None) -> Out:
    """x[B,K] @ w[K,N] f32 through the fused BFP datapath, both operands
    quantized per K-tile of ``bk`` (Scheme.TILED, block_k = bk)."""
    _check_operands(x.shape, w.shape, bk)
    check_overflow(bk, l_i + l_w)
    check_epilogue(out_bits, out_block, w.shape[1])
    if x.device.type == "cpu":
        return bfp_matmul_plain(x, w, l_i, l_w, bk, out_bits, out_block)
    if matmul_core(False, bk, x.shape[1], w.shape[1], l_i, l_w, out_bits,
                   out_block) == "mma":
        return _launch_patch(x, w, l_i, l_w, bk, out_bits, out_block)
    return _launch(x.float().contiguous(), None, w.float().contiguous(),
                   None, l_i, l_w, bk, out_bits, out_block, "bfp_matmul")


def bfp_matmul_prequant(x: torch.Tensor, wm: torch.Tensor, ws: torch.Tensor,
                        *, l_i: int, l_w: int, bk: int,
                        out_bits: Optional[int] = None,
                        out_block: Optional[int] = None) -> Out:
    """x[B,K] @ prequant weight (int8 mantissa [K,N] + steps [K//bk,N]).
    ``l_w`` only sizes the overflow check."""
    _check_operands(x.shape, wm.shape, bk, ws=ws)
    check_overflow(bk, l_i + l_w)
    _check_wire(wm, "prequant")
    check_epilogue(out_bits, out_block, wm.shape[1])
    if x.device.type == "cpu":
        return bfp_matmul_prequant_plain(x, wm, ws, l_i, l_w, bk, out_bits,
                                         out_block)
    if matmul_core(True, bk, x.shape[1], wm.shape[1], l_i, l_w, out_bits,
                   out_block) == "mma":
        return _launch_mma(x, wm, ws, l_i, bk, out_bits, out_block)
    return _launch(x.float().contiguous(), None, wm.contiguous(),
                   ws.float().contiguous(), l_i, l_w, bk, out_bits,
                   out_block, "bfp_matmul_prequant")


def bfp_matmul_xprequant(xm: torch.Tensor, xs: torch.Tensor, w: torch.Tensor,
                         *, l_i: int, l_w: int, bk: int,
                         out_bits: Optional[int] = None,
                         out_block: Optional[int] = None) -> Out:
    """Wire-format activations (int8 mantissa [B,K] + steps [B,K//bk],
    the previous layer's epilogue output) @ float w[K,N].  ``l_i`` only
    sizes the overflow check."""
    _check_operands(xm.shape, w.shape, bk, xs=xs)
    check_overflow(bk, l_i + l_w)
    _check_wire(xm, "activation-prequant")
    check_epilogue(out_bits, out_block, w.shape[1])
    if xm.device.type == "cpu":
        return bfp_matmul_xprequant_plain(xm, xs, w, l_i, l_w, bk, out_bits,
                                          out_block)
    if matmul_core(False, bk, xm.shape[1], w.shape[1], l_i, l_w, out_bits,
                   out_block, wire_x=True) == "mma":
        return _launch_wire(xm, xs, w, None, l_w, bk, out_bits, out_block)
    return _launch(xm.contiguous(), xs.float().contiguous(),
                   w.float().contiguous(), None, l_i, l_w, bk, out_bits,
                   out_block, "bfp_matmul_xprequant")


def bfp_matmul_xwprequant(xm: torch.Tensor, xs: torch.Tensor,
                          wm: torch.Tensor, ws: torch.Tensor, *, l_i: int,
                          l_w: int, bk: int, out_bits: Optional[int] = None,
                          out_block: Optional[int] = None) -> Out:
    """Both operands on the wire: no quantization in the kernel, only
    int8 dots and power-of-two rescales."""
    _check_operands(xm.shape, wm.shape, bk, xs=xs, ws=ws)
    check_overflow(bk, l_i + l_w)
    _check_wire(xm, "activation-prequant")
    _check_wire(wm, "prequant")
    check_epilogue(out_bits, out_block, wm.shape[1])
    if xm.device.type == "cpu":
        return bfp_matmul_xwprequant_plain(xm, xs, wm, ws, l_i, l_w, bk,
                                           out_bits, out_block)
    if matmul_core(True, bk, xm.shape[1], wm.shape[1], l_i, l_w, out_bits,
                   out_block, wire_x=True) == "mma":
        return _launch_wire(xm, xs, wm, ws, l_w, bk, out_bits, out_block)
    return _launch(xm.contiguous(), xs.float().contiguous(), wm.contiguous(),
                   ws.float().contiguous(), l_i, l_w, bk, out_bits,
                   out_block, "bfp_matmul_xwprequant")
