"""The unified BFP GEMM execution layer (counterpart of
``repro.engine.core``).

Every model GEMM lands on :func:`gemm`; CNN convolutions land on
:func:`conv2d`, which dispatches to a backend's fused conv (cuda: the
implicit-im2col kernel, no patch matrix in device memory) or falls back
to materialized im2col + :func:`gemm`:

    gemm(x, w, policy, path="fc6")
    conv2d(x, w_hwio, policy, stride=2, padding="SAME", path="stem")

``w`` is a float matrix or the prequant ``{"m", "s"}`` wire format;
``policy`` is None (float), a BFPPolicy, a PolicyMap, or a bound
``Plan`` (``engine.bind``), whose per-site entries then supply the
resolved policy and backend.  Both shims and the Plan entries emit
``engine.taps`` events from the real datapath (``engine.taps``).

Activation wire format.  ``out_policy=`` asks an execution to emit the
CONSUMING layer's quantized input ``{"m": int8 [.., N], "s": f32
[.., N//bk]}`` instead of dense float: on a backend with ``out_quant``
the kernel call requantizes (the tile kernel in its epilogue, so the
f32 activation never reaches device memory; the mma core by an output
format pass that reads it once from a scratch tensor); anywhere else the
engine requantizes the
float output in a second step (``prequant_act``).  An ``x`` already in
that format goes straight to an ``act_prequant`` backend, and is
dequantized first for every other route (bit-identical by quantization
idempotence).

Gradients.  A call whose dense float operands require grad takes the
autograd route of ``repro_torch.grad`` (where ``repro`` routes it
through ``repro.grad``'s custom VJP): the same forward, and both
backward GEMMs through the backend registry under the grad-path
policies, on the kernels for the cuda backend.  The calls that route
cannot take (``noise=``, ``out_policy=``, a wire-format x) have no
backward on the kernel backend, whose plain version's round has zero
derivative and whose CUDA launch writes fresh outputs; a float operand
that requires grad there raises
:class:`~repro_torch.engine.backends.BackendUnsupportedError` instead of
getting a silent zero gradient.  The emulated backend's straight-through
gradients are unchanged.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.core.bfp import Rounding, Scheme
from repro_torch.core.conv_utils import conv_weight_matrix, im2col
from repro_torch.core.prequant import (act_block, dequantize_act,
                                       is_prequant, prequant_act,
                                       quantize_cnn_param_tree,
                                       quantize_param_tree)
from repro_torch.engine import backends as BK
from repro_torch.engine import taps as TAPS
from repro_torch.engine.policy_map import PolicyLike, resolve_policy

__all__ = ["gemm", "conv2d", "conv2d_im2col", "prequantize",
           "prequantize_cnn"]


def _check_out_policy(out_policy) -> None:
    """Epilogue requantization is defined for exactly the activation wire
    format: TILED blocks along the last axis, round-to-nearest, int8
    mantissas (block_k | N and l_i <= 8 are checked where the sizes are
    known: the ops epilogue rule and ``prequant_act``)."""
    if out_policy.scheme is not Scheme.TILED or not out_policy.block_k:
        raise ValueError(
            "out_policy must be Scheme.TILED with an explicit block_k "
            f"(activation wire format); got scheme={out_policy.scheme}, "
            f"block_k={out_policy.block_k}")
    if out_policy.rounding is not Rounding.ROUND:
        raise ValueError("out_policy requantization is round-to-nearest "
                         f"only; got {out_policy.rounding}")


#: backends with no backward outside the autograd route
_NO_BACKWARD = ("cuda", "pallas")


def _refuse_grad(be: BK.Backend, *operands: Any) -> None:
    """Raise where autograd would see a kernel-backend call as constant:
    grad mode on and a float tensor operand that requires grad.  Only
    the calls the autograd route refuses reach here in grad mode."""
    if be.name not in _NO_BACKWARD or not torch.is_grad_enabled():
        return
    if any(isinstance(a, torch.Tensor) and a.is_floating_point()
           and a.requires_grad for a in operands):
        raise BK.BackendUnsupportedError(
            f"backend {be.name!r} has no backward for this call: with "
            f"noise=, out_policy= or a wire-format x it is off the "
            f"autograd route, and an operand that requires grad would "
            f"get a zero gradient.  Drop those arguments to train through "
            f"the kernels, run under torch.no_grad() or inference_mode, "
            f"or use backend 'emulated' for straight-through gradients")


def _act_ok(be: BK.Backend, pol, w_block: Optional[int], x: dict) -> bool:
    """Can ``be`` consume this wire-format x natively?  ``w_block`` is a
    prequant weight's sidecar block (None for float weights), which must
    match the activation block."""
    if not be.act_prequant or pol is None:
        return False
    if x["m"].dtype != torch.int8:
        return False
    bk = act_block(x)
    return pol.block_k in (None, bk) and w_block in (None, bk)


def _act_ok_gemm(be: BK.Backend, pol, w, x2d: dict) -> bool:
    w_block = (w["m"].shape[-2] // w["s"].shape[-2] if is_prequant(w)
               else None)
    return _act_ok(be, pol, w_block, x2d)


def _act_ok_conv(be: BK.Backend, pol, w, x: dict) -> bool:
    """Conv blocks are per (pixel, channel chunk), so the act block must
    match a weight sidecar's HWIO-major K block."""
    w_block = None
    if is_prequant(w):
        kh, kw, c, _ = w["m"].shape
        w_block = kh * kw * c // w["s"].shape[-2]
    return _act_ok(be, pol, w_block, x)


def _reshape_out(out: Any, lead, n: int) -> Any:
    """Restore leading dims on a dense or wire-format output."""
    if is_prequant(out):
        bq = out["m"].shape[-1] // out["s"].shape[-1]
        return {"m": out["m"].reshape(*lead, n),
                "s": out["s"].reshape(*lead, n // bq)}
    return out.reshape(*lead, n)


def _gemm_exec(x: Any, w: Any, pol, backend: Optional[BK.Backend] = None,
               strict: bool = False, path: Optional[str] = None,
               out_policy=None, warned=None,
               noise: Optional[torch.Tensor] = None) -> Tuple[Any, BK.Backend]:
    """Flatten leading dims, run the (given or selected) backend matmul.
    ``x`` may be the wire format; ``out_policy`` requests it on the
    output; ``noise`` (STOCHASTIC rounding of x) reaches the matmul only
    when given."""
    n = (w["m"] if is_prequant(w) else w).shape[-1]
    if out_policy is not None:
        _check_out_policy(out_policy)
    x_pq = is_prequant(x)
    xm = x["m"] if x_pq else x
    lead = xm.shape[:-1]
    x2d = ({"m": xm.reshape(-1, xm.shape[-1]),
            "s": x["s"].reshape(-1, x["s"].shape[-1])} if x_pq
           else x.reshape(-1, x.shape[-1]))
    be = backend
    if be is None:
        be = (BK.get_backend("float") if pol is None
              else BK.select_backend(pol, w, strict=strict, path=path,
                                     warned=warned))
    _refuse_grad(be, x, w)
    if x_pq and not _act_ok_gemm(be, pol, w, x2d):
        x2d = dequantize_act(x2d)
    kw = {} if noise is None else {"noise": noise}
    if out_policy is not None and be.out_quant and pol is not None:
        out = be.matmul(x2d, w, pol, out_policy=out_policy, **kw)
    else:
        out = be.matmul(x2d, w, pol, **kw)
        if out_policy is not None:
            out = prequant_act(out, out_policy)
    return _reshape_out(out, lead, n), be


def _conv_exec(x: Any, w: Any, pol, stride: int, padding: str,
               backend: Optional[BK.Backend] = None, strict: bool = False,
               path: Optional[str] = None, out_policy=None,
               warned=None,
               noise: Optional[torch.Tensor] = None) -> Tuple[Any, BK.Backend]:
    """Fused conv when the backend has one and can honour (policy,
    geometry); honest materialized-im2col + matmul fallback otherwise
    (the emulated backend, and any policy the kernels cannot run, take
    that route).  With ``backend=None`` the conv slot of the REQUESTED
    backend is consulted (policy None: the registered "float" backend)
    and the im2col GEMM selects with support checks, falling back to
    emulated with a warning unless ``strict``.  ``noise`` reaches only
    the im2col GEMM, as ``repro``'s ``key``: the fused convs round to
    nearest."""
    if out_policy is not None:
        _check_out_policy(out_policy)
    be = backend
    if be is None:
        be = BK.get_backend("float" if pol is None else pol.backend_name)
    fused = be.conv is not None and be.conv_supports(pol, w, stride, padding)
    if is_prequant(x) and not (fused and _act_ok_conv(be, pol, w, x)):
        x = dequantize_act(x)
    if fused:
        _refuse_grad(be, x, w)
        if out_policy is not None and be.out_quant and pol is not None:
            return be.conv(x, w, pol, stride, padding,
                           out_policy=out_policy), be
        out = be.conv(x, w, pol, stride, padding)
        if out_policy is not None:
            out = prequant_act(out, out_policy)
        return out, be
    return _conv_im2col_exec(x, w, pol, stride, padding, backend=backend,
                             strict=strict, path=path, out_policy=out_policy,
                             warned=warned, noise=noise)


def _conv_im2col_exec(x, w, pol, stride, padding, backend=None,
                      strict=False, path=None, out_policy=None,
                      warned=None, noise=None) -> Tuple[Any, BK.Backend]:
    if is_prequant(x):      # im2col gathers float patches
        x = dequantize_act(x)
    prequant = is_prequant(w)
    kh, kw, c, oc = (w["m"] if prequant else w).shape
    cols, (b, oh, ow) = im2col(x, kh, kw, stride, padding)
    wmat = ({"m": conv_weight_matrix(w["m"]), "s": w["s"]} if prequant
            else conv_weight_matrix(w))
    out, be = _gemm_exec(cols, wmat, pol, backend=backend, strict=strict,
                         path=path, out_policy=out_policy, warned=warned,
                         noise=noise)
    return _reshape_out(out, (b, oh, ow), oc), be


# ---------------------------------------------------------------------------
# Execute-then-tap (one implementation shared by the per-call shims and
# the bound Plan entries, so tap events cannot diverge between the two)
# ---------------------------------------------------------------------------

def _tap_view(y: Any) -> Any:
    """Dense float view of an execution output for tap observers (taps
    compare against float references; the wire-format dict is
    dequantized for observation only — the model still sees the dict)."""
    return dequantize_act(y) if is_prequant(y) else y


def _adopt_transform(out: Any, view: Any, new: Any, out_policy) -> Any:
    """Fold a transforming tap's replacement back into the datapath: a
    wire-format output is requantized under the same ``out_policy``, so
    the change lands on the f32 accumulator before the epilogue."""
    if new is view:
        return out
    if is_prequant(out):
        return prequant_act(new, out_policy)
    return new


def gemm_and_tap(x, w, pol, backend=None, strict=False, path=None,
                 out_policy=None, warned=None, noise=None) -> Any:
    out, be = _gemm_exec(x, w, pol, backend=backend, strict=strict,
                         path=path, out_policy=out_policy, warned=warned,
                         noise=noise)
    if TAPS.active():
        view = _tap_view(out)
        new = TAPS.emit("gemm", path, pol, be.name, x, w, view,
                        float_fn=lambda: _gemm_exec(x, w, None)[0])
        out = _adopt_transform(out, view, new, out_policy)
    return out


def conv_and_tap(x, w, pol, stride, padding, backend=None, strict=False,
                 path=None, out_policy=None, warned=None,
                 noise=None) -> Any:
    out, be = _conv_exec(x, w, pol, stride, padding, backend=backend,
                         strict=strict, path=path, out_policy=out_policy,
                         warned=warned, noise=noise)
    if TAPS.active():
        view = _tap_view(out)
        new = TAPS.emit("conv", path, pol, be.name, x, w, view,
                        float_fn=lambda: _conv_im2col_exec(
                            x, w, None, stride, padding)[0],
                        stride=stride, padding=padding)
        out = _adopt_transform(out, view, new, out_policy)
    return out


def _plan_cls():
    # engine.plan imports this module; resolve the cycle at call time
    from repro_torch.engine.plan import Plan
    return Plan


def _grad_vjp():
    # repro_torch.grad.vjp builds its autograd functions on top of
    # gemm_and_tap / conv_and_tap, so it imports this module
    from repro_torch.grad import vjp
    return vjp


def _routed(x, w, noise, out_policy, padding: Optional[str] = None) -> bool:
    """Does this call take the autograd route?  ``padding`` is None for a
    GEMM and the conv's padding otherwise.  Dense float operands that
    autograd will differentiate take it; a call it will not differentiate
    (serving under ``inference_mode``) runs the same forward directly."""
    if not torch.is_grad_enabled() or padding not in (None, "SAME",
                                                       "VALID"):
        return False
    return (_grad_vjp().routable(x, w, noise, out_policy)
            and w.ndim == (2 if padding is None else 4)
            and (x.requires_grad or w.requires_grad))


def gemm(x: Any, w: Any, policy: PolicyLike = None, *,
         path: Optional[str] = None, out_policy=None,
         noise: Optional[torch.Tensor] = None) -> Any:
    """``x[..., K] @ w[K, N]`` through the policy-selected BFP backend.

    ``w``: float [K, N] or prequant ``{"m": [K, N], "s": [K//bk, N]}``.
    Leading dims of ``x`` are flattened for the 2-D backends and restored.
    ``x`` may be the activation wire format ``{"m": int8 [.., K], "s":
    [.., K//bk]}``; ``out_policy=`` (the CONSUMING layer's policy)
    returns that format instead of dense float.  ``noise``: uniform noise
    in [0, 1) with x's elements, for a STOCHASTIC policy (where ``repro``
    takes ``key=``).
    """
    if isinstance(policy, _plan_cls()):
        return policy.gemm(x, w, path=path, out_policy=out_policy,
                           noise=noise)
    if _routed(x, w, noise, out_policy):
        # the autograd route: the same forward (gemm_and_tap), backward
        # GEMMs through the backend registry under the grad-path policies
        return _grad_vjp().gemm(x, w, policy, path)
    return gemm_and_tap(x, w, resolve_policy(policy, path), path=path,
                        out_policy=out_policy, noise=noise)


def conv2d(x: Any, w: Any, policy: PolicyLike = None, *,
           stride: int = 1, padding: str = "SAME",
           path: Optional[str] = None, out_policy=None,
           noise: Optional[torch.Tensor] = None) -> Any:
    """NHWC convolution through the policy-selected BFP backend.

    ``x``: [B, H, W, C] float, or the NHWC activation wire format (blocks
    per (pixel, channel chunk)); ``w``: HWIO [kh, kw, C, OC] float or the
    prequant ``{"m": int8 HWIO, "s": [K//bk, OC]}`` wire format.
    ``out_policy=`` returns the wire format, as in :func:`gemm`: chained
    convs on the cuda backend hand ``{"m", "s"}`` activations layer to
    layer, the f32 output only a kernel call's scratch.
    ``noise``: uniform noise in [0, 1) for a STOCHASTIC policy (where
    ``repro`` takes ``key=``), with the elements of the im2col patch
    matrix ``[B*OH*OW, kh*kw*C]`` in its row-major order (HWIO-major
    K): the x that the GEMM rounds, so the rule of :func:`gemm`.
    """
    if isinstance(policy, _plan_cls()):
        return policy.conv2d(x, w, path=path, stride=stride, padding=padding,
                             out_policy=out_policy, noise=noise)
    if _routed(x, w, noise, out_policy, padding):
        return _grad_vjp().conv2d(x, w, policy, stride, padding, path)
    return conv_and_tap(x, w, resolve_policy(policy, path), stride,
                        padding, path=path, out_policy=out_policy,
                        noise=noise)


def conv2d_im2col(x: Any, w: Any, pol, stride: int = 1,
                  padding: str = "SAME", out_policy=None,
                  noise: Optional[torch.Tensor] = None) -> Any:
    """The materialized-im2col route (paper Fig. 1's matrix form) through
    the GEMM engine; :func:`conv2d`'s fallback.  ``pol`` is an already
    resolved BFPPolicy or None; a wire-format ``x`` is dequantized;
    ``noise`` as in :func:`conv2d`.  Emits no tap event (the
    :func:`conv2d` entry does, once per conv site)."""
    return _conv_im2col_exec(x, w, pol, stride, padding,
                             out_policy=out_policy, noise=noise)[0]


def prequantize(params: Any, policy: PolicyLike) -> Any:
    """Quantize an LM param tree's GEMM weights once (wire format); a
    PolicyMap rule resolving to None keeps that leaf float.  The result
    feeds the same model code: every backend consumes the wire format."""
    return quantize_param_tree(params, policy)


def prequantize_cnn(params: Any, policy: PolicyLike) -> Any:
    """Quantize a CNN param tree's conv and dense weights once (wire
    format); every backend consumes the result directly."""
    return quantize_cnn_param_tree(params, policy)
