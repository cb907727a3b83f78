"""Policy-level wrappers around the BFP kernels (counterpart of
``repro.kernels.ops``).

They turn a ``BFPPolicy`` (and a prequant sidecar) into the kernel's
block size and mantissa widths and check the wire format.  A policy
with ``block_k=None`` takes ``repro``'s defaults: whole-K (kh*kw*C) for
a conv, ``tune.tables.fallback_block_k`` for a GEMM; a
whole-K block over the int32 overflow guard raises.  The CUDA
kernels mask ragged rows, columns and K themselves and choose their own
thread-block tiles, so no operand is padded here; on the CPU the plain
versions zero-pad K to a block multiple exactly as ``repro`` does.
Model code reaches these through ``repro_torch.engine`` (backend
"cuda", also registered as "pallas"), never directly.

``bfp_quantize`` is the offline block-formatting entry point (a weight
matrix to int8 mantissas + int32 exponents): one kernel launch per
call, with the outputs of ``repro``'s padded wrapper and no padding.

``x2d``/``x`` may be the activation wire format ``{"m", "s"}`` (int8
mantissas + f32 steps per (row or pixel, K-chunk), a previous layer's
epilogue output): the x-prequant kernels consume it as it is.
``out_policy=`` asks for that format on the output: the kernel call's
requantize epilogue emits it when the blocks fit (``out_policy.l_i <=
8``, ``block_k`` divides N and the tile kernel's column tile), on the
tile kernel straight from the f32 accumulator, on the mma core by the
output format pass over the f32 output (the same bits); otherwise the
f32 output is requantized with ``prequant_act`` in a second step, as
``repro``'s ``_finish_gemm``/``_finish_conv`` do.

Every wrapper takes ``repro``'s arguments:

* ``interpret=`` is accepted and changes nothing: the tensor's device
  picks the route (a CPU tensor runs the plain version, ``repro``'s
  interpret mode; a CUDA tensor launches the kernel or raises).
* ``dot_impl=`` / ``pipeline=`` are validated by ``repro``'s rule
  (``kernels.bfp_matmul.resolve_dot_impl``: ``"int8"`` with an inline
  L > 8 raises, and so on) and then change nothing: ``repro`` pins every
  mode bit-identical, and each core here has one datapath.
* ``tiles=`` takes precedence over the active tune cache
  (``tune.cache.lookup_tiles``, which a bound plan activates), which
  takes precedence over the fallback rule, as in ``repro``.  A GEMM
  takes (bm, bn, bk), a conv (bm, bn) or (bm, bn, bk) on the card and
  ``repro``'s (t_oh, bn) on the CPU.  What the tile means depends on the
  route:

  - ``bk``: with a pinned ``policy.block_k`` (or a prequant sidecar's or
    wire x's block) the block is semantics, and a different ``bk`` in
    ``tiles=`` raises; with ``block_k=None`` a GEMM's tuned ``bk`` IS
    the block and changes the bits, exactly as in ``repro``.  A conv's
    block is never tuned (``policy.block_k``, else whole-K).
  - (bm, bn) on the card: a call on the int8 mma core runs that tile,
    which must be one of ``kernels._mma.MMA_TILES`` and fit the core's
    shared memory at ``bk``; it replaces ``_mma.mma_tile``'s choice for
    the call.  The tile kernel's tile is fixed at compile time
    (``_mma.tile_kernel_tile``): a call routed there accepts only that
    tile, and any other raises ``ValueError`` naming ``MMA_TILES``.  No
    tile is silently ignored on a route that cannot run it.
  - (bm, bn) / (t_oh, bn) on the CPU: the plain versions take no row
    or column tile, and their bits do not depend on one (nor do
    ``repro``'s), so any is accepted.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Optional, Tuple, Union

import torch

from repro_torch.core.conv_utils import conv_geometry
from repro_torch.core.policy import BFPPolicy
from repro_torch.core.prequant import act_block, is_prequant, prequant_act
from repro_torch.kernels import _mma
from repro_torch.kernels import bfp_conv as KC
from repro_torch.kernels import bfp_matmul as KM
from repro_torch.kernels import bfp_quantize as KQ
from repro_torch.tune import cache as _tune
from repro_torch.tune.tables import fallback_block_k

__all__ = ["bfp_matmul", "bfp_matmul_prequant", "bfp_conv2d",
           "bfp_conv2d_prequant", "bfp_quantize"]

ActOrTensor = Union[torch.Tensor, dict]
Tiles = Optional[Tuple[int, ...]]


def _on_cpu(x: ActOrTensor) -> bool:
    """Does the call run the plain versions (``repro``'s interpret)?"""
    return (x["m"] if is_prequant(x) else x).device.type == "cpu"


def _sidecar_block(k: int, ws: torch.Tensor, policy: BFPPolicy) -> int:
    t = ws.shape[0]
    if t == 0 or k % t:
        raise ValueError(f"sidecar {tuple(ws.shape)} incompatible with K={k}")
    bk = k // t
    if policy.block_k not in (None, bk):
        raise ValueError(f"policy.block_k={policy.block_k} != prequant "
                         f"block {bk}")
    return bk


def _act_pin(x: dict, policy: BFPPolicy) -> int:
    """The block of a wire-format x, which the policy may not contradict."""
    bk = act_block(x)
    if policy.block_k not in (None, bk):
        raise ValueError(f"policy.block_k={policy.block_k} != activation "
                         f"prequant block {bk}")
    return bk


def _gemm_tiles(b: int, k: int, n: int, policy: BFPPolicy, cpu: bool,
                tiles: Tiles, bk_pin: Optional[int]):
    """((bm, bn) to force on the card or None, bk) for a GEMM: explicit
    ``tiles`` > active tune cache > fallback rule (``repro``'s
    ``_gemm_tiles``).  The pinned block (``bk_pin``: a sidecar's or wire
    x's, else ``policy.block_k``) is the bk; an explicit different one
    raises, a cached one keyed on a free policy block gives way to a
    sidecar's, as in ``repro``.  On the CPU no tile is forced."""
    explicit = tiles is not None
    if not explicit:
        tiles = _tune.lookup_tiles("gemm", b, k, n, policy.l_i, policy.l_w,
                                   policy.block_k, cpu)
    pin = bk_pin if bk_pin is not None else policy.block_k
    if tiles is None:
        return None, pin or fallback_block_k(k, None,
                                             policy.l_w + policy.l_i)
    bm, bn, bk = tiles
    if pin is not None and bk != pin:
        if explicit or policy.block_k is not None:
            raise ValueError(f"tiles bk={bk} != the BFP block {pin} (a "
                             f"pinned block is the K tile)")
        bk = pin
    return (None if cpu else (bm, bn)), bk


def _card_tile(tile, core: str, bk: int,
               out_bits: Optional[int]) -> Optional[int]:
    """The mma-core tile index a (bm, bn) forces on a card call routed to
    ``core``; the tile kernel accepts only its own fixed tile."""
    if core == "mma":
        return _mma.tile_index(tile, bk)
    own = _mma.tile_kernel_tile(out_bits)
    if tuple(tile) != own:
        raise ValueError(
            f"tile {tuple(tile)}: this call runs on the tile kernel, whose "
            f"tile is fixed at {own}; MMA_TILES = {_mma.MMA_TILES} apply "
            f"only on the mma core")
    return None


def _check_dot(dot_impl: str, policy: BFPPolicy, bk: int, cpu: bool,
               x_pq: bool, w_pq: bool) -> None:
    """Raise where ``repro``'s ``resolve_dot_impl`` raises ("auto" never
    does)."""
    if dot_impl != "auto":
        KM.resolve_dot_impl(dot_impl, l_i=policy.l_i, l_w=policy.l_w,
                            bk=bk, interpret=cpu, x_pq=x_pq, w_pq=w_pq)


def _epilogue_cfg(out_policy: Optional[BFPPolicy],
                  n: int) -> Optional[Tuple[int, int]]:
    """(out_bits, out_block) when the kernel can emit the consumer's
    activation blocks itself; None -> the two-step route."""
    if out_policy is None:
        return None
    bq = out_policy.block_k
    if bq and out_policy.l_i <= 8 and n % bq == 0 \
            and KM.EPILOGUE_COLS % bq == 0:
        return (out_policy.l_i, bq)
    return None


def _run(kernel, args, kw, out_policy: Optional[BFPPolicy], n: int,
         tile=None, core: Optional[Callable[..., str]] = None) -> Any:
    """Launch with the fused epilogue when it fits, else requantize the
    f32 output in a second step (bit-identical on finite outputs).  A
    card ``tile`` is checked against the route ``core(out_bits,
    out_block)`` names and forced on the mma core's launches."""
    fused = _epilogue_cfg(out_policy, n)
    ob, obk = fused if fused is not None else (None, None)
    scope = contextlib.nullcontext()
    if tile is not None:
        scope = _mma.forced_tile(_card_tile(tile, core(ob, obk), kw["bk"],
                                            ob))
    with scope:
        if fused is not None:
            m, s = kernel(*args, **kw, out_bits=ob, out_block=obk)
            return {"m": m, "s": s}
        out = kernel(*args, **kw)
    return out if out_policy is None else prequant_act(out, out_policy)


def bfp_matmul(x2d: ActOrTensor, w: torch.Tensor, policy: BFPPolicy,
               interpret: Optional[bool] = None, *,
               out_policy: Optional[BFPPolicy] = None, tiles: Tiles = None,
               dot_impl: str = "auto", pipeline: bool = True) -> Any:
    """x2d[B,K] (or its wire format) @ w[K,N] through the fused kernel
    (Scheme.TILED); see the module docstring for ``interpret``,
    ``tiles``, ``dot_impl`` and ``pipeline``."""
    x_pq, cpu = is_prequant(x2d), _on_cpu(x2d)
    b, k = (x2d["m"] if x_pq else x2d).shape
    n = w.shape[1]
    tile, bk = _gemm_tiles(b, k, n, policy, cpu, tiles,
                           _act_pin(x2d, policy) if x_pq else None)
    _check_dot(dot_impl, policy, bk, cpu, x_pq, False)
    kw = dict(l_i=policy.l_i, l_w=policy.l_w, bk=bk)
    core = lambda ob, obk: KM.matmul_core(  # noqa: E731
        False, bk, k, n, policy.l_i, policy.l_w, ob, obk, wire_x=x_pq)
    if x_pq:
        return _run(KM.bfp_matmul_xprequant, (x2d["m"], x2d["s"], w), kw,
                    out_policy, n, tile, core)
    return _run(KM.bfp_matmul, (x2d, w), kw, out_policy, n, tile, core)


def bfp_matmul_prequant(x2d: ActOrTensor, wm: torch.Tensor,
                        ws: torch.Tensor, policy: BFPPolicy,
                        interpret: Optional[bool] = None, *,
                        out_policy: Optional[BFPPolicy] = None,
                        tiles: Tiles = None, dot_impl: str = "auto",
                        pipeline: bool = True) -> Any:
    """x2d[B,K] (or its wire format, at the same block) @ prequant weight
    (int8 mantissa [K,N] + steps [K//bk,N]); the sidecar's block IS the
    kernel's K tile."""
    x_pq, cpu = is_prequant(x2d), _on_cpu(x2d)
    b, k = (x2d["m"] if x_pq else x2d).shape
    n = wm.shape[1]
    bk = _sidecar_block(k, ws, policy)
    if x_pq and act_block(x2d) != bk:
        raise ValueError(f"activation prequant block {act_block(x2d)} "
                         f"!= weight prequant block {bk}")
    tile, _ = _gemm_tiles(b, k, n, policy, cpu, tiles, bk)
    _check_dot(dot_impl, policy, bk, cpu, x_pq, True)
    kw = dict(l_i=policy.l_i, l_w=policy.l_w, bk=bk)
    core = lambda ob, obk: KM.matmul_core(  # noqa: E731
        True, bk, k, n, policy.l_i, policy.l_w, ob, obk, wire_x=x_pq)
    if x_pq:
        return _run(KM.bfp_matmul_xwprequant, (x2d["m"], x2d["s"], wm, ws),
                    kw, out_policy, n, tile, core)
    return _run(KM.bfp_matmul_prequant, (x2d, wm, ws), kw, out_policy, n,
                tile, core)


def _conv_x_prequant_check(x: dict, c: int, bk: int,
                           policy: BFPPolicy) -> None:
    bk_act = _act_pin(x, policy)
    if bk_act != bk or c % bk:
        raise ValueError(f"conv activation prequant needs block_k | C "
                         f"(block {bk_act}, C={c})")


def _conv_tiles(x_shape, w_shape, stride: int, padding: str,
                policy: BFPPolicy, cpu: bool, tiles: Tiles, bk: int):
    """(bm, bn) forced on a card conv, or None: explicit ``tiles`` > the
    active tune cache (keyed on the im2col view: B * OH * OW patch rows,
    the rows ``repro``'s tuner stores) > the core's own rule.  On the
    CPU the plain versions take no tile (``repro``'s (t_oh, bn) change
    no bit), so None; a card tile's ``bk``, where given, must be the
    conv's block."""
    if tiles is None and _tune.get_cache() is None:
        return None
    b, h, wd, c = x_shape
    kh, kw, _, oc = w_shape
    if tiles is None:
        oh, ow, _, _ = conv_geometry(h, wd, kh, kw, stride, padding)
        tiles = _tune.lookup_tiles("conv", b * oh * ow, kh * kw * c, oc,
                                   policy.l_i, policy.l_w, policy.block_k,
                                   cpu)
    if tiles is None or cpu:
        return None
    if len(tiles) == 3 and tiles[2] not in (None, bk):
        raise ValueError(f"tiles bk={tiles[2]} != the conv's block {bk}")
    return tuple(tiles[:2])


def bfp_conv2d(x: ActOrTensor, w_hwio: torch.Tensor, policy: BFPPolicy,
               stride: int = 1, padding: str = "SAME",
               interpret: Optional[bool] = None, *,
               out_policy: Optional[BFPPolicy] = None, tiles: Tiles = None,
               dot_impl: str = "auto", pipeline: bool = True) -> Any:
    """NHWC conv (float x or its wire format) through the implicit-im2col
    kernel (Scheme.TILED); the block is ``policy.block_k``, else a wire
    x's own block, else whole-K."""
    x_pq, cpu = is_prequant(x), _on_cpu(x)
    kh, kw_, c, oc = w_hwio.shape
    xt = x["m"] if x_pq else x
    bk = policy.block_k or (act_block(x) if x_pq else kh * kw_ * c)
    if x_pq:
        _conv_x_prequant_check(x, xt.shape[3], bk, policy)
    tile = _conv_tiles(xt.shape, w_hwio.shape, stride, padding, policy, cpu,
                       tiles, bk)
    _check_dot(dot_impl, policy, bk, cpu, x_pq, False)
    kw = dict(l_i=policy.l_i, l_w=policy.l_w, bk=bk, stride=stride,
              padding=padding)
    core = lambda ob, obk: KC.conv_core(  # noqa: E731
        x_pq, False, bk, xt.shape[3], oc, policy.l_i, ob, policy.l_w, obk)
    if x_pq:
        return _run(KC.bfp_conv2d_xprequant, (x["m"], x["s"], w_hwio), kw,
                    out_policy, oc, tile, core)
    return _run(KC.bfp_conv2d, (x, w_hwio), kw, out_policy, oc, tile, core)


def bfp_conv2d_prequant(x: ActOrTensor, wm_hwio: torch.Tensor,
                        ws: torch.Tensor, policy: BFPPolicy,
                        stride: int = 1, padding: str = "SAME",
                        interpret: Optional[bool] = None, *,
                        out_policy: Optional[BFPPolicy] = None,
                        tiles: Tiles = None, dot_impl: str = "auto",
                        pipeline: bool = True) -> Any:
    """NHWC conv with prequant weights (int8 HWIO mantissa + GEMM-view
    steps [K//bk, OC]); bit-exact vs :func:`bfp_conv2d` on the weights
    the sidecar was quantized from.  ``x`` may be the wire format at the
    same block (``bk | C``): the fully prequantized conv->conv chain."""
    x_pq, cpu = is_prequant(x), _on_cpu(x)
    kh, kw_, c, oc = wm_hwio.shape
    xt = x["m"] if x_pq else x
    bk = _sidecar_block(kh * kw_ * c, ws, policy)
    if x_pq:
        _conv_x_prequant_check(x, xt.shape[3], bk, policy)
    tile = _conv_tiles(xt.shape, wm_hwio.shape, stride, padding, policy,
                       cpu, tiles, bk)
    _check_dot(dot_impl, policy, bk, cpu, x_pq, True)
    kw = dict(l_i=policy.l_i, l_w=policy.l_w, bk=bk, stride=stride,
              padding=padding)
    core = lambda ob, obk: KC.conv_core(  # noqa: E731
        x_pq, True, bk, xt.shape[3], oc, policy.l_i, ob, None, obk)
    if x_pq:
        return _run(KC.bfp_conv2d_xwprequant, (x["m"], x["s"], wm_hwio, ws),
                    kw, out_policy, oc, tile, core)
    return _run(KC.bfp_conv2d_prequant, (x, wm_hwio, ws), kw, out_policy,
                oc, tile, core)


def bfp_quantize(x: torch.Tensor, bits: int, block_k: int,
                 interpret: Optional[bool] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[M, K] -> (int8 mantissas [M, K], int32 exponents
    [M, ceil(K / block_k)]), one block per (row, K-tile).  ``repro`` pads
    rows to ``aligned_tile(M, 256)`` and K to a ``block_k`` multiple and
    slices back; nothing is padded here: rows are independent, the kernel
    masks the ragged last K-tile and the plain version zero-pads K
    itself, and zeros never change a block's amax, so the outputs are
    the same.  ``interpret`` changes nothing: the device picks."""
    return KQ.bfp_quantize(x, bits=bits, bk=block_k)
