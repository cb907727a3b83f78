"""Policy-level wrappers around the BFP kernels (counterpart of
``repro.kernels.ops``).

They turn a ``BFPPolicy`` (and a prequant sidecar) into the kernel's
block size and mantissa widths and check the wire format.  The CUDA
kernels mask ragged rows, columns and K themselves and choose their own
thread-block tiles, so no operand is padded here; on the CPU the plain
versions zero-pad K to a block multiple exactly as ``repro`` does.
Model code reaches these through ``repro_torch.engine`` (backend
"cuda", also registered as "pallas"), never directly.
"""
from __future__ import annotations

import torch

from repro_torch.core.policy import BFPPolicy
from repro_torch.kernels import bfp_conv as KC
from repro_torch.kernels import bfp_matmul as KM

__all__ = ["bfp_matmul", "bfp_matmul_prequant", "bfp_conv2d",
           "bfp_conv2d_prequant"]


def _policy_block(policy: BFPPolicy) -> int:
    # No tune cache or fallback tile table is ported yet, so the block
    # must come from the policy (the "cuda" backend refuses None too).
    if policy.block_k is None:
        raise ValueError("the BFP kernels need policy.block_k (Scheme.TILED)")
    return policy.block_k


def _sidecar_block(k: int, ws: torch.Tensor, policy: BFPPolicy) -> int:
    t = ws.shape[0]
    if t == 0 or k % t:
        raise ValueError(f"sidecar {tuple(ws.shape)} incompatible with K={k}")
    bk = k // t
    if policy.block_k not in (None, bk):
        raise ValueError(f"policy.block_k={policy.block_k} != prequant "
                         f"block {bk}")
    return bk


def bfp_matmul(x2d: torch.Tensor, w: torch.Tensor,
               policy: BFPPolicy) -> torch.Tensor:
    """x2d[B,K] @ w[K,N] through the fused kernel (Scheme.TILED)."""
    return KM.bfp_matmul(x2d, w, l_i=policy.l_i, l_w=policy.l_w,
                         bk=_policy_block(policy))


def bfp_matmul_prequant(x2d: torch.Tensor, wm: torch.Tensor,
                        ws: torch.Tensor, policy: BFPPolicy) -> torch.Tensor:
    """x2d[B,K] @ prequant weight (int8 mantissa [K,N] + steps [K//bk,N]);
    the sidecar's block IS the kernel's K tile."""
    bk = _sidecar_block(x2d.shape[1], ws, policy)
    return KM.bfp_matmul_prequant(x2d, wm, ws, l_i=policy.l_i,
                                  l_w=policy.l_w, bk=bk)


def bfp_conv2d(x: torch.Tensor, w_hwio: torch.Tensor, policy: BFPPolicy,
               stride: int = 1, padding: str = "SAME") -> torch.Tensor:
    """NHWC conv through the implicit-im2col kernel (Scheme.TILED); the
    block is ``policy.block_k``."""
    return KC.bfp_conv2d(x, w_hwio, l_i=policy.l_i, l_w=policy.l_w,
                         bk=_policy_block(policy), stride=stride,
                         padding=padding)


def bfp_conv2d_prequant(x: torch.Tensor, wm_hwio: torch.Tensor,
                        ws: torch.Tensor, policy: BFPPolicy,
                        stride: int = 1,
                        padding: str = "SAME") -> torch.Tensor:
    """NHWC conv with prequant weights (int8 HWIO mantissa + GEMM-view
    steps [K//bk, OC]); bit-exact vs :func:`bfp_conv2d` on the weights
    the sidecar was quantized from."""
    kh, kw, c, _ = wm_hwio.shape
    bk = _sidecar_block(kh * kw * c, ws, policy)
    return KC.bfp_conv2d_prequant(x, wm_hwio, ws, l_i=policy.l_i,
                                  l_w=policy.l_w, bk=bk, stride=stride,
                                  padding=padding)
