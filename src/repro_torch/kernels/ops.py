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
"""
from __future__ import annotations

from typing import Any, Optional, Tuple, Union

import torch

from repro_torch.core.policy import BFPPolicy
from repro_torch.core.prequant import act_block, is_prequant, prequant_act
from repro_torch.kernels import bfp_conv as KC
from repro_torch.kernels import bfp_matmul as KM
from repro_torch.kernels import bfp_quantize as KQ
from repro_torch.tune.tables import fallback_block_k

__all__ = ["bfp_matmul", "bfp_matmul_prequant", "bfp_conv2d",
           "bfp_conv2d_prequant", "bfp_quantize"]

ActOrTensor = Union[torch.Tensor, dict]


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


def _run(kernel, args, kw, out_policy: Optional[BFPPolicy],
         n: int) -> Any:
    """Launch with the fused epilogue when it fits, else requantize the
    f32 output in a second step (bit-identical on finite outputs)."""
    fused = _epilogue_cfg(out_policy, n)
    if fused is not None:
        m, s = kernel(*args, **kw, out_bits=fused[0], out_block=fused[1])
        return {"m": m, "s": s}
    out = kernel(*args, **kw)
    return out if out_policy is None else prequant_act(out, out_policy)


def bfp_matmul(x2d: ActOrTensor, w: torch.Tensor, policy: BFPPolicy, *,
               out_policy: Optional[BFPPolicy] = None) -> Any:
    """x2d[B,K] (or its wire format) @ w[K,N] through the fused kernel
    (Scheme.TILED)."""
    kw = dict(l_i=policy.l_i, l_w=policy.l_w)
    n = w.shape[1]
    if is_prequant(x2d):
        kw["bk"] = _act_pin(x2d, policy)
        return _run(KM.bfp_matmul_xprequant, (x2d["m"], x2d["s"], w), kw,
                    out_policy, n)
    kw["bk"] = fallback_block_k(x2d.shape[1], policy.block_k,
                                policy.l_w + policy.l_i)
    return _run(KM.bfp_matmul, (x2d, w), kw, out_policy, n)


def bfp_matmul_prequant(x2d: ActOrTensor, wm: torch.Tensor,
                        ws: torch.Tensor, policy: BFPPolicy, *,
                        out_policy: Optional[BFPPolicy] = None) -> Any:
    """x2d[B,K] (or its wire format, at the same block) @ prequant weight
    (int8 mantissa [K,N] + steps [K//bk,N]); the sidecar's block IS the
    kernel's K tile."""
    x_pq = is_prequant(x2d)
    bk = _sidecar_block((x2d["m"] if x_pq else x2d).shape[1], ws, policy)
    kw = dict(l_i=policy.l_i, l_w=policy.l_w, bk=bk)
    n = wm.shape[1]
    if x_pq:
        if act_block(x2d) != bk:
            raise ValueError(f"activation prequant block {act_block(x2d)} "
                             f"!= weight prequant block {bk}")
        return _run(KM.bfp_matmul_xwprequant, (x2d["m"], x2d["s"], wm, ws),
                    kw, out_policy, n)
    return _run(KM.bfp_matmul_prequant, (x2d, wm, ws), kw, out_policy, n)


def _conv_x_prequant_check(x: dict, c: int, bk: int,
                           policy: BFPPolicy) -> None:
    bk_act = _act_pin(x, policy)
    if bk_act != bk or c % bk:
        raise ValueError(f"conv activation prequant needs block_k | C "
                         f"(block {bk_act}, C={c})")


def bfp_conv2d(x: ActOrTensor, w_hwio: torch.Tensor, policy: BFPPolicy,
               stride: int = 1, padding: str = "SAME", *,
               out_policy: Optional[BFPPolicy] = None) -> Any:
    """NHWC conv (float x or its wire format) through the implicit-im2col
    kernel (Scheme.TILED); the block is ``policy.block_k``, else a wire
    x's own block, else whole-K."""
    kw = dict(l_i=policy.l_i, l_w=policy.l_w, stride=stride,
              padding=padding)
    oc = w_hwio.shape[3]
    if is_prequant(x):
        bk = policy.block_k or act_block(x)
        _conv_x_prequant_check(x, x["m"].shape[3], bk, policy)
        kw["bk"] = bk
        return _run(KC.bfp_conv2d_xprequant, (x["m"], x["s"], w_hwio), kw,
                    out_policy, oc)
    kh, kw_, c, _ = w_hwio.shape
    kw["bk"] = policy.block_k or kh * kw_ * c
    return _run(KC.bfp_conv2d, (x, w_hwio), kw, out_policy, oc)


def bfp_conv2d_prequant(x: ActOrTensor, wm_hwio: torch.Tensor,
                        ws: torch.Tensor, policy: BFPPolicy,
                        stride: int = 1, padding: str = "SAME", *,
                        out_policy: Optional[BFPPolicy] = None) -> Any:
    """NHWC conv with prequant weights (int8 HWIO mantissa + GEMM-view
    steps [K//bk, OC]); bit-exact vs :func:`bfp_conv2d` on the weights
    the sidecar was quantized from.  ``x`` may be the wire format at the
    same block (``bk | C``): the fully prequantized conv->conv chain."""
    kh, kw_, c, oc = wm_hwio.shape
    bk = _sidecar_block(kh * kw_ * c, ws, policy)
    kw = dict(l_i=policy.l_i, l_w=policy.l_w, bk=bk, stride=stride,
              padding=padding)
    if is_prequant(x):
        _conv_x_prequant_check(x, x["m"].shape[3], bk, policy)
        return _run(KC.bfp_conv2d_xwprequant, (x["m"], x["s"], wm_hwio, ws),
                    kw, out_policy, oc)
    return _run(KC.bfp_conv2d_prequant, (x, wm_hwio, ws), kw, out_policy, oc)


def bfp_quantize(x: torch.Tensor, bits: int,
                 block_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """[M, K] -> (int8 mantissas [M, K], int32 exponents
    [M, ceil(K / block_k)]), one block per (row, K-tile).  ``repro`` pads
    rows to ``aligned_tile(M, 256)`` and K to a ``block_k`` multiple and
    slices back; nothing is padded here: rows are independent, the kernel
    masks the ragged last K-tile and the plain version zero-pads K
    itself, and zeros never change a block's amax, so the outputs are
    the same."""
    return KQ.bfp_quantize(x, bits=bits, bk=block_k)
