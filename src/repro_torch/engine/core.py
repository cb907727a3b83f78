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
resolved policy and backend.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.core.conv_utils import conv_weight_matrix, im2col
from repro_torch.core.prequant import is_prequant, quantize_cnn_param_tree
from repro_torch.engine import backends as BK
from repro_torch.engine.policy_map import PolicyLike, resolve_policy

__all__ = ["gemm", "conv2d", "conv2d_im2col", "prequantize_cnn"]


def _gemm_exec(x: torch.Tensor, w: Any, pol,
               backend: Optional[BK.Backend] = None, strict: bool = False,
               path: Optional[str] = None) -> Tuple[torch.Tensor, BK.Backend]:
    """Flatten leading dims, run the (given or selected) backend matmul."""
    n = (w["m"] if is_prequant(w) else w).shape[-1]
    lead = x.shape[:-1]
    be = backend
    if be is None:
        be = (BK.get_backend("float") if pol is None
              else BK.select_backend(pol, w, strict=strict, path=path))
    out = be.matmul(x.reshape(-1, x.shape[-1]), w, pol)
    return out.reshape(*lead, n), be


def _conv_exec(x: torch.Tensor, w: Any, pol, stride: int, padding: str,
               backend: Optional[BK.Backend] = None, strict: bool = False,
               path: Optional[str] = None) -> Tuple[torch.Tensor, BK.Backend]:
    """Fused conv when the backend has one and can honour (policy,
    geometry); honest materialized-im2col + matmul fallback otherwise.
    With ``backend=None`` the conv slot of the REQUESTED backend is
    consulted (policy None: the registered "float" backend)."""
    be = backend
    if be is None:
        be = BK.get_backend("float" if pol is None else pol.backend_name)
    if be.conv is not None and be.conv_supports(pol, w, stride, padding):
        return be.conv(x, w, pol, stride, padding), be
    return _conv_im2col_exec(x, w, pol, stride, padding, backend=backend,
                             strict=strict, path=path)


def _conv_im2col_exec(x, w, pol, stride, padding, backend=None,
                      strict=False,
                      path=None) -> Tuple[torch.Tensor, BK.Backend]:
    prequant = is_prequant(w)
    kh, kw, c, oc = (w["m"] if prequant else w).shape
    cols, (b, oh, ow) = im2col(x, kh, kw, stride, padding)
    wmat = ({"m": conv_weight_matrix(w["m"]), "s": w["s"]} if prequant
            else conv_weight_matrix(w))
    out, be = _gemm_exec(cols, wmat, pol, backend=backend, strict=strict,
                         path=path)
    return out.reshape(b, oh, ow, oc), be


def _plan_cls():
    # engine.plan imports this module; resolve the cycle at call time
    from repro_torch.engine.plan import Plan
    return Plan


def gemm(x: torch.Tensor, w: Any, policy: PolicyLike = None, *,
         path: Optional[str] = None) -> torch.Tensor:
    """``x[..., K] @ w[K, N]`` through the policy-selected BFP backend.

    ``w``: float [K, N] or prequant ``{"m": [K, N], "s": [K//bk, N]}``.
    Leading dims of ``x`` are flattened for the 2-D backends and restored.
    """
    if isinstance(policy, _plan_cls()):
        return policy.gemm(x, w, path=path)
    return _gemm_exec(x, w, resolve_policy(policy, path), path=path)[0]


def conv2d(x: torch.Tensor, w: Any, policy: PolicyLike = None, *,
           stride: int = 1, padding: str = "SAME",
           path: Optional[str] = None) -> torch.Tensor:
    """NHWC convolution through the policy-selected BFP backend.

    ``x``: [B, H, W, C] float; ``w``: HWIO [kh, kw, C, OC] float or the
    prequant ``{"m": int8 HWIO, "s": [K//bk, OC]}`` wire format.
    """
    if isinstance(policy, _plan_cls()):
        return policy.conv2d(x, w, path=path, stride=stride, padding=padding)
    return _conv_exec(x, w, resolve_policy(policy, path), stride, padding,
                      path=path)[0]


def conv2d_im2col(x: torch.Tensor, w: Any, pol, stride: int = 1,
                  padding: str = "SAME") -> torch.Tensor:
    """The materialized-im2col route (paper Fig. 1's matrix form) through
    the GEMM engine; :func:`conv2d`'s fallback.  ``pol`` is an already
    resolved BFPPolicy or None."""
    return _conv_im2col_exec(x, w, pol, stride, padding)[0]


def prequantize_cnn(params: Any, policy: PolicyLike) -> Any:
    """Quantize a CNN param tree's conv and dense weights once (wire
    format); every backend consumes the result directly."""
    return quantize_cnn_param_tree(params, policy)
