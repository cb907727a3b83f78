"""BFP GEMM — the paper's fixed-point datapath in plain PyTorch, the
"emulated" backend (counterpart of ``repro.core.bfp_dot``).

``bfp_matmul_2d(x2d, w, policy)`` computes ``x2d @ w`` with both operands
first block-formatted (paper eq. 1) under the policy's partition scheme,
the multiply-accumulate in the INTEGER domain (paper Fig. 2), then one
power-of-two rescale per block pair.  It runs every scheme and rounding,
and is what a policy the kernels cannot run falls back to.

Orientation: ``y[B, N] = x[B, K] @ w[K, N]``; x rows are the paper's I
columns and w columns the paper's W rows:

    =======  ====================  ====================
    scheme   w blocks (paper W)    x blocks (paper I)
    =======  ====================  ====================
    EQ2      whole matrix          whole matrix
    EQ3      per column            per row
    EQ4      per column            whole matrix     <- paper's choice
    EQ5      whole matrix          per row
    TILED    per (column, K-tile)  per (row, K-tile)
    =======  ====================  ====================

The integer products are exact: mantissas are multiplied as float64
(``torch.matmul``; every partial stays below 2^53 because the int32
overflow guard bounds it by 2^31), then rounded once to f32 — what
``repro``'s int32 dot followed by an f32 conversion gives.  Sums over
chunks or K-tiles run in index order.  STOCHASTIC rounding takes an
explicit uniform-noise tensor in x's element order (``noise=``) where
``repro`` takes a PRNG key.

Gradients: ``bfp_matmul_2d`` with ``policy.straight_through`` is the
legacy straight-through estimator (a ``torch.autograd.Function``):
gradients as if the GEMM were float over the dequantized operands.  The
engine routes a call whose operands require grad through
``repro_torch.grad`` instead, whose float backward over the same
dequantized operands gives these gradients.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import bfp
from repro_torch.core.bfp import BFPBlock, Scheme
from repro_torch.core.policy import BFPPolicy
from repro_torch.dist import sharding as DS

__all__ = ["bfp_dot", "bfp_matmul_2d", "bfp_matmul_2d_prequant",
           "quantize_activations", "quantize_weights"]


def quantize_weights(w: torch.Tensor, policy: BFPPolicy) -> BFPBlock:
    """Block-format a [K, N] weight matrix (paper W, transposed)."""
    if policy.scheme is Scheme.EQ2 or policy.scheme is Scheme.EQ5:
        return bfp.quantize(w, policy.l_w, (0, 1), policy.rounding)
    if policy.scheme in (Scheme.EQ3, Scheme.EQ4):
        return bfp.quantize(w, policy.l_w, (0,), policy.rounding)  # per col
    # TILED: per (column, K-tile); w [K, N] is paper W^T, so the "i"
    # orientation of bfp_quantize_matrix blocks along axis 0
    return bfp.bfp_quantize_matrix(w, policy.l_w, "i", Scheme.TILED,
                                   policy.block_k, policy.rounding)


def quantize_activations(x2d: torch.Tensor, policy: BFPPolicy,
                         noise: Optional[torch.Tensor] = None) -> BFPBlock:
    """Block-format a [B, K] activation matrix (paper I, transposed).
    EQ2's and EQ4's block is the whole matrix, whose rows are the batch's:
    inside a forward split over a data group its max spans the group
    (``dist.sharding.group_amax``)."""
    if policy.scheme in (Scheme.EQ2, Scheme.EQ4):
        return bfp.quantize(x2d, policy.l_i, (0, 1), policy.rounding, noise,
                            DS.group_amax)
    if policy.scheme in (Scheme.EQ3, Scheme.EQ5):
        return bfp.quantize(x2d, policy.l_i, (1,), policy.rounding, noise)
    return bfp.bfp_quantize_matrix(x2d, policy.l_i, "w", Scheme.TILED,
                                   policy.block_k, policy.rounding, noise)


def _exact_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Integer-valued a @ b (batched or not), exact, rounded once to f32.
    ``+ 0.0`` turns the -0.0 of a single product 0 * -m into +0.0, the
    zero of ``repro``'s int32 dot, and changes no other value."""
    return torch.matmul(a.double(), b.double()).float() + 0.0


def _int_matmul(mx: torch.Tensor, mw: torch.Tensor,
                l_sum: int) -> torch.Tensor:
    """Exact fixed-point matmul with overflow-safe K-chunking.

    int32 accumulation of L_W+L_I-bit products is exact for
    K <= 2^(32 - l_sum) (paper Fig. 2 sizing).  A larger K is split into
    chunks of that size whose f32 partials are summed in chunk order.
    """
    k = mx.shape[-1]
    safe_k = bfp.max_safe_k(0, 0, 32 - l_sum)       # == 2 ** (32 - l_sum)
    if k <= safe_k:
        return _exact_dot(mx, mw)
    n_chunks = -(-k // safe_k)
    pad = n_chunks * safe_k - k
    mxc = torch.nn.functional.pad(mx.double(), (0, pad)).reshape(
        mx.shape[0], n_chunks, safe_k).transpose(0, 1)
    mwc = torch.nn.functional.pad(mw.double(), (0, 0, 0, pad)).reshape(
        n_chunks, safe_k, mw.shape[1])
    part = torch.matmul(mxc, mwc).float()            # [c, B, N]
    return _sum_in_order(part)


def _sum_in_order(part: torch.Tensor) -> torch.Tensor:
    """part[0] + part[1] + ... along the leading axis, in f32."""
    out = part[0]
    for i in range(1, part.shape[0]):
        out = out + part[i]
    return out


def _bfp_matmul_2d_impl(x2d: torch.Tensor, w: torch.Tensor,
                        policy: BFPPolicy,
                        noise: Optional[torch.Tensor]) -> torch.Tensor:
    """BFP x2d[B,K] @ w[K,N] on the integer datapath."""
    bx = (quantize_activations(x2d, policy, noise)
          if policy.quantize_inputs else None)
    bw = quantize_weights(w, policy) if policy.quantize_weights else None
    if bx is None and bw is None:
        return x2d @ w
    if bx is None or bw is None:  # one operand float: dequantize the other
        xq = x2d if bx is None else bx.dequantize()
        wq = w if bw is None else bw.dequantize()
        return xq @ wq

    l_sum = policy.l_w + policy.l_i
    if policy.scheme is not Scheme.TILED:
        mo = _int_matmul(bx.mantissa, bw.mantissa, l_sum)
        # 2^(ex - (L_I-2)) * 2^(ew - (L_W-2)), broadcast [B|1, 1] x [1, N|1]
        return mo * (bx.scale * bw.scale)

    # TILED: exponents vary along the K-tiles -> rescale each tile's partial
    bk = policy.block_k or x2d.shape[-1]
    b, k = x2d.shape
    n = w.shape[1]
    t = k // bk
    mx = bx.mantissa.reshape(b, t, bk).transpose(0, 1)      # [t, B, bk]
    mw = bw.mantissa.reshape(t, bk, n)
    part = _exact_dot(mx, mw)                                # [t, B, N]
    sx = bfp.pow2(bx.exponent - (policy.l_i - 2))            # [B, t]
    sw = bfp.pow2(bw.exponent - (policy.l_w - 2))            # [t, N]
    scaled = part * sx.t()[:, :, None] * sw[:, None, :]
    return _sum_in_order(scaled)


class _BfpMatmulSTE(torch.autograd.Function):
    """Straight-through estimator: the forward is the BFP datapath, the
    gradients those of a float GEMM over the DEQUANTIZED operands
    (``g @ wq.T``, ``xq.T @ g``), the standard QAT estimator."""

    @staticmethod
    def forward(ctx, x2d, w, policy):
        ctx.policy = policy
        ctx.save_for_backward(x2d, w)
        return _bfp_matmul_2d_impl(x2d, w, policy, None)

    @staticmethod
    def backward(ctx, g):
        x2d, w = ctx.saved_tensors
        pol = ctx.policy
        xq = (quantize_activations(x2d, pol).dequantize()
              if pol.quantize_inputs else x2d)
        wq = quantize_weights(w, pol).dequantize() if pol.quantize_weights \
            else w
        return g @ wq.t(), xq.t() @ g, None


def _check_tile(bk: int, policy: BFPPolicy, what: str) -> None:
    if bk > bfp.max_safe_k(policy.l_w, policy.l_i):
        raise ValueError(
            f"{what}={bk} overflows int32 accumulation for "
            f"L_W+L_I={policy.l_w + policy.l_i} (paper Fig. 2 sizing)")


def bfp_matmul_2d(x2d: torch.Tensor, w: torch.Tensor, policy: BFPPolicy,
                  noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """2-D BFP matmul; differentiable (straight-through) iff
    ``policy.straight_through`` and no ``noise`` is given."""
    if policy.scheme is Scheme.TILED:
        _check_tile(policy.block_k or x2d.shape[-1], policy, "block_k")
    if policy.straight_through and noise is None:
        return _BfpMatmulSTE.apply(x2d, w, policy)
    return _bfp_matmul_2d_impl(x2d, w, policy, noise)


def bfp_matmul_2d_prequant(x2d: torch.Tensor, wm: torch.Tensor,
                           ws: torch.Tensor, policy: BFPPolicy,
                           noise: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """BFP x2d[B,K] @ pre-quantized weight (int mantissa [K, N] + steps
    [K//bk, N] from ``core.prequant.prequant_leaf``).  The weight-side
    quantization is skipped; the activation side follows ``policy``.  For
    TILED with a matching ``block_k`` — and for eq. (3)/(4) with
    per-column sidecars (bk == K) — this is bit-exact to
    ``quantize_weights`` + :func:`bfp_matmul_2d`, because ``ws`` IS the
    quantizer's step array.  No straight-through estimator."""
    b, k = x2d.shape
    kw, n = wm.shape
    t = ws.shape[0]
    if kw != k or t == 0 or k % t:
        raise ValueError(f"prequant shapes x{tuple(x2d.shape)} "
                         f"m{tuple(wm.shape)} s{tuple(ws.shape)} "
                         f"inconsistent")
    bk = k // t
    if policy.block_k not in (None, bk) and policy.scheme is Scheme.TILED:
        raise ValueError(f"policy.block_k={policy.block_k} != prequant "
                         f"block {bk}")
    if not policy.quantize_inputs:
        s_full = torch.repeat_interleave(ws, bk, dim=0)
        return x2d @ (wm.float() * s_full)

    l_sum = policy.l_w + policy.l_i
    if t == 1:
        # one weight block per column: the paper schemes' contraction;
        # _int_matmul handles K beyond the int32-safe bound
        if policy.scheme is Scheme.TILED:
            bx = bfp.bfp_quantize_matrix(x2d, policy.l_i, "w", Scheme.TILED,
                                         bk, policy.rounding, noise)
            sx = bfp.pow2(bx.exponent - (policy.l_i - 2))
        else:
            bx = quantize_activations(x2d, policy, noise)
            sx = bx.scale
        mo = _int_matmul(bx.mantissa, wm, l_sum)
        return mo * (sx.reshape(b, 1) if sx.numel() != 1 else sx) * ws

    _check_tile(bk, policy, "prequant block")
    if policy.scheme is Scheme.TILED:
        bx = bfp.bfp_quantize_matrix(x2d, policy.l_i, "w", Scheme.TILED,
                                     bk, policy.rounding, noise)
        sx_e = bfp.pow2(bx.exponent
                        - (policy.l_i - 2)).t()[:, :, None]      # [t,B,1]
    else:
        bx = quantize_activations(x2d, policy, noise)
        sx_e = bx.scale[None]                                    # [1,B|1,1]
    mx = bx.mantissa.reshape(b, t, bk).transpose(0, 1)           # [t,B,bk]
    part = _exact_dot(mx, wm.reshape(t, bk, n))                  # [t,B,N]
    return _sum_in_order(part * sx_e * ws[:, None, :])


def bfp_dot(x: torch.Tensor, w, policy=None,
            noise: Optional[torch.Tensor] = None,
            path: Optional[str] = None) -> torch.Tensor:
    """``x[..., K] @ w[K, N]`` with an optional BFP datapath: a shim over
    :func:`repro_torch.engine.gemm`, which owns backend selection,
    per-layer policies (``policy`` may be a PolicyMap or a bound Plan;
    ``path`` names the calling layer) and prequant ``{"m", "s"}``
    weights."""
    from repro_torch import engine  # the engine builds on this module
    return engine.gemm(x, w, policy, path=path, noise=noise)
