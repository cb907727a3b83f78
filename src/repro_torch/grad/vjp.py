"""Autograd functions routing backward GEMMs through the BFP engine
(counterpart of ``repro.grad.vjp``).

One :class:`torch.autograd.Function` for GEMMs and one for convs, each
configured by a frozen ``_GemmCfg`` / ``_ConvCfg`` passed as a
non-tensor argument.  The forward runs the unchanged datapath
(``engine.core.gemm_and_tap`` / ``conv_and_tap``: forward numerics and
tap events are those of the unrouted engine), and the backward lowers
the two gradient contractions onto ``engine.core._gemm_exec``:

    dL/dx = dy[M, N] @ W^T[N, K]       ("gemm_dx" / "conv_dx")
    dL/dw = x^T[K, M] @ dy[M, N]       ("gemm_dw" / "conv_dw")

so each backward GEMM gets real backend selection (float / emulated /
cuda with honest fallback) under its own resolved policy, and emits a
backward tap event carrying exactly the executed operands.  On the cuda
backend ("pallas") both run on the ``bfp_matmul`` kernels: the mma core
after its patch format pass where the fitted block is a power of two
from 32 to 512 and N is a multiple of 4, the tile kernel otherwise
(``kernels.bfp_matmul.matmul_core``); the wrappers copy the transposed
operands to contiguous memory before the launch.

Operand orientation inside a backward GEMM: the LEFT operand is the
activation side of the policy (``l_i`` bits) and the RIGHT operand the
weight side (``l_w``): for dL/dx the incoming gradient is left and W^T
right; for dL/dw the saved activations are left and the gradient right.

The residuals saved by the forward are the RAW operands; the backward
re-derives the site's dequantized operands (the ``core.bfp_dot``
straight-through linearization point), so with float grad policies the
gradients are those of the legacy straight-through estimator, and of
plain autograd when the site itself is float.  A TILED block that does
not divide K (VGG16's conv1_1: K = 27 at block 128) is linearized at
the kernels' own blocks, the ragged last block zero-padded as the
forward kernel pads it; ``repro`` raises there (its ``bfp_quantize_matrix``
needs ``block_k | K``), and agrees with this everywhere else.

col2im, the transpose of the patch extraction, is the autograd
transpose of ``core.conv_utils.im2col`` (pad, strided slices, stack):
a sum of ``kh*kw`` slabs, each added in the autograd engine's fixed
order, with no atomics.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch import _tree
from repro_torch._tree import is_float
from repro_torch.core.bfp import Scheme
from repro_torch.core.bfp_dot import quantize_activations, quantize_weights
from repro_torch.core.conv_utils import conv_weight_matrix, im2col
from repro_torch.core.policy import BFPPolicy
from repro_torch.engine import core as EC
from repro_torch.engine import taps as TAPS
from repro_torch.engine.policy_map import PolicyLike, resolve_policy
from repro_torch.grad.paths import (GradSpec, fit_grad_policy, grad_path,
                                    resolve_grad_policy)

__all__ = ["gemm", "gemm_bound", "conv2d", "conv2d_bound", "routable"]


def routable(x: Any, w: Any, noise, out_policy) -> bool:
    """Can this engine call take the autograd route?

    Dense float tensor operands only: prequant ``{"m", "s"}`` weights and
    wire-format activations hold integer mantissas (nothing to
    differentiate); STOCHASTIC ``noise`` and wire-format ``out_policy``
    outputs are inference-side features.  Everything refused here keeps
    the engine path, where the kernel backend refuses an operand that
    requires grad (``engine.core``).
    """
    if noise is not None or out_policy is not None:
        return False
    return all(isinstance(a, torch.Tensor) and a.is_floating_point()
               for a in (x, w))


def _dequantized(a: torch.Tensor, pol: BFPPolicy, quantize,
                 k_dim: int) -> torch.Tensor:
    """``quantize(a, pol).dequantize()``; a TILED block that does not
    divide K is taken over K zero-padded to a block multiple (the
    padding is inert: no block's amax changes) and the padding cut."""
    k, bk = a.shape[k_dim], pol.block_k
    if pol.scheme is not Scheme.TILED or not bk or k % bk == 0:
        return quantize(a, pol).dequantize()
    pad = -(-k // bk) * bk - k
    padded = F.pad(a, (0, pad) if k_dim == 1 else (0, 0, 0, pad))
    return quantize(padded, pol).dequantize().narrow(k_dim, 0, k)


def _linearize(x: torch.Tensor, w: torch.Tensor, pol: Optional[BFPPolicy]):
    """The linearization point: the site's dequantized operands.

    Float backward GEMMs run over THESE (the straight-through estimator);
    quantized backward GEMMs also start from them, the backward
    arithmetic then adding its own formatting, as a datapath whose
    gradient buffers hold the forward wire values would.
    """
    if pol is None:
        return x, w
    xq, wq = x, w
    if pol.quantize_inputs:
        x2d = x.reshape(-1, x.shape[-1])
        xq = _dequantized(x2d, pol, quantize_activations, 1).reshape(x.shape)
    if pol.quantize_weights:
        wq = _dequantized(w, pol, quantize_weights, 0)
    return xq, wq


def _grad_gemm(a2d: torch.Tensor, b2d: torch.Tensor, spec: GradSpec,
               gpath: Optional[str], kind: str, strict: bool) -> torch.Tensor:
    """One backward GEMM ``a2d[M, K'] @ b2d[K', N']`` through the engine,
    with its backward tap event."""
    pol = fit_grad_policy(spec.policy, a2d.shape[-1])
    # a fitted tile invalidates the bind-time backend choice (kernel
    # support depends on block_k): select again, honestly, per call
    be = spec.backend if pol == spec.policy else None
    out, used = EC._gemm_exec(a2d, b2d, pol, backend=be, strict=strict,
                              path=gpath)
    if TAPS.active():
        out = TAPS.emit(kind, gpath, pol, used.name, a2d, b2d, out,
                        float_fn=lambda: EC._gemm_exec(a2d, b2d, None)[0])
    return out


@dataclasses.dataclass(frozen=True)
class _GemmCfg:
    pol: Optional[BFPPolicy]
    backend: Any                 #: pre-selected forward Backend or None
    dx: GradSpec
    dw: GradSpec
    path: Optional[str] = None
    strict: bool = False


class _Gemm(torch.autograd.Function):
    """``x[..., K] @ w[K, N]`` on the engine, backward GEMMs on it too."""

    @staticmethod
    def forward(ctx, x, w, cfg: _GemmCfg):
        ctx.cfg = cfg
        ctx.save_for_backward(x, w)
        return EC.gemm_and_tap(x, w, cfg.pol, backend=cfg.backend,
                               strict=cfg.strict, path=cfg.path)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        cfg = ctx.cfg
        xq, wq = _linearize(x, w, cfg.pol)
        g2d = g.reshape(-1, g.shape[-1])
        x2d = xq.reshape(-1, xq.shape[-1])
        # both GEMMs run whatever autograd needs, so the backward taps
        # see every site (repro's eager backward emits both)
        dx = _grad_gemm(g2d, wq.t(), cfg.dx, grad_path(cfg.path, "dx"),
                        "gemm_dx", cfg.strict)
        dw = _grad_gemm(x2d.t(), g2d, cfg.dw, grad_path(cfg.path, "dw"),
                        "gemm_dw", cfg.strict)
        return (dx.reshape(x.shape).to(x.dtype) if ctx.needs_input_grad[0]
                else None,
                dw.to(w.dtype) if ctx.needs_input_grad[1] else None, None)


@dataclasses.dataclass(frozen=True)
class _ConvCfg:
    pol: Optional[BFPPolicy]
    backend: Any
    dx: GradSpec
    dw: GradSpec
    stride: int
    padding: str
    path: Optional[str] = None
    strict: bool = False


class _Conv(torch.autograd.Function):
    """NHWC conv on the engine, its backward GEMMs on it too and col2im
    as the autograd transpose of ``im2col``."""

    @staticmethod
    def forward(ctx, x, w, cfg: _ConvCfg):
        ctx.cfg = cfg
        ctx.save_for_backward(x, w)
        return EC.conv_and_tap(x, w, cfg.pol, cfg.stride, cfg.padding,
                               backend=cfg.backend, strict=cfg.strict,
                               path=cfg.path)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        cfg = ctx.cfg
        kh, kw, _, oc = w.shape
        with torch.enable_grad():
            xr = x.detach().requires_grad_()
            cols = im2col(xr, kh, kw, cfg.stride, cfg.padding)[0]
        colsq, wmatq = _linearize(cols.detach(), conv_weight_matrix(w),
                                  cfg.pol)
        g2d = g.reshape(-1, oc)
        dcols = _grad_gemm(g2d, wmatq.t(), cfg.dx,
                           grad_path(cfg.path, "dx"), "conv_dx", cfg.strict)
        # col2im: the (linear) transpose of im2col adds the patch
        # gradients back onto the input feature map
        dx, = torch.autograd.grad(cols, xr, dcols)
        del cols, dcols, xr
        dwmat = _grad_gemm(colsq.t(), g2d, cfg.dw,
                           grad_path(cfg.path, "dw"), "conv_dw", cfg.strict)
        return (dx.to(x.dtype) if ctx.needs_input_grad[0] else None,
                dwmat.reshape(w.shape).to(w.dtype)
                if ctx.needs_input_grad[1] else None, None)


# ---------------------------------------------------------------------------
# Entry points: per call (resolve here) and plan-bound (pre-resolved Site)
# ---------------------------------------------------------------------------

def _specs(policy: PolicyLike, path: Optional[str]):
    return (GradSpec(resolve_grad_policy(policy, path, "dx")),
            GradSpec(resolve_grad_policy(policy, path, "dw")))


def _site_spec(site, which: str) -> GradSpec:
    """Grad spec of a bound Site; a hand-built Site (dx/dw None) falls
    back to its own forward policy with the straight-through default."""
    spec = getattr(site, which)
    if spec is not None:
        return spec
    pol = site.policy
    if pol is None or pol.straight_through:
        return GradSpec(None, None)
    return GradSpec(pol, None)


def gemm(x, w, policy: PolicyLike, path: Optional[str],
         strict: bool = False):
    dx, dw = _specs(policy, path)
    cfg = _GemmCfg(resolve_policy(policy, path), None, dx, dw, path, strict)
    return _Gemm.apply(x, w, cfg)


def gemm_bound(x, w, site):
    """Dispatch for a bound ``engine.plan.Site`` (grad specs resolved and
    backends selected at bind time)."""
    cfg = _GemmCfg(site.policy, site.backend, _site_spec(site, "dx"),
                   _site_spec(site, "dw"), site.path, False)
    return _Gemm.apply(x, w, cfg)


def conv2d(x, w, policy: PolicyLike, stride: int, padding: str,
           path: Optional[str], strict: bool = False):
    dx, dw = _specs(policy, path)
    cfg = _ConvCfg(resolve_policy(policy, path), None, dx, dw, stride,
                   padding, path, strict)
    return _Conv.apply(x, w, cfg)


def conv2d_bound(x, w, site, stride: int, padding: str):
    cfg = _ConvCfg(site.policy, site.backend, _site_spec(site, "dx"),
                   _site_spec(site, "dw"), stride, padding, site.path,
                   False)
    return _Conv.apply(x, w, cfg)


def value_and_grad(loss_fn, params):
    """``jax.value_and_grad(loss_fn, has_aux=True)(params)`` for a
    params tree: ``((loss, aux), grads)``, detached.  Every float leaf is
    made a fresh leaf that requires grad, and a leaf the loss does not
    reach gets zeros, as ``jax.grad`` gives; non-float leaves get
    themselves as their gradient (they pass through an update
    untouched)."""
    leaves, treedef = _tree.flatten(params)
    live = [p.detach().requires_grad_() if is_float(p) else p
            for p in leaves]
    wrt = [p for p in live if is_float(p)]
    with torch.enable_grad():
        loss, aux = loss_fn(_tree.unflatten(treedef, live))
        gs = iter(torch.autograd.grad(loss, wrt, allow_unused=True,
                                      materialize_grads=True))
    grads = _tree.unflatten(treedef, [next(gs) if is_float(p) else p
                                      for p in live])
    return (loss.detach(), _tree.tree_map(torch.Tensor.detach, aux)), grads
