"""Offline weight pre-quantization — the paper's deployment mode
(counterpart of ``repro.core.prequant``).

Wire format, consumed first-class by every engine backend:

    {"m": int mantissa [.., K, N],  "s": f32 steps [.., K//bk, N]}

``s`` holds the quantizer's power-of-two steps ``2^(e - (L_W - 2))``,
so the prequant kernels reproduce BIT-EXACTLY what in-line weight
quantization would have produced for Scheme.TILED with the same
``block_k`` — but the quantization runs once, not per forward.
Conv kernels keep their mantissa in HWIO with the sidecar in the GEMM
view ``[kh*kw*C // bk, OC]`` (HWIO-major K, ``core.conv_utils``).

``quantize_param_tree`` converts LM trees (>=2-D GEMM leaves, stacked
``[L, K, N]`` and ``[L, E, K, N]`` MoE experts included: each trailing
``[K, N]`` matrix quantizes on its own); ``quantize_cnn_param_tree``
walks CNN trees.  Both take a single policy or a per-layer PolicyMap.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch import _tree
from repro_torch.core import bfp
from repro_torch.core.policy import BFPPolicy

__all__ = ["quantize_param_tree", "quantize_cnn_param_tree", "prequant_leaf",
           "prequant_conv_leaf", "dequantize_prequant", "is_prequant",
           "prequant_act", "dequantize_act", "act_block", "lm_rule_path",
           "lm_eligible", "cnn_rule_path", "detect_tree_kind"]


def is_prequant(w: Any) -> bool:
    return isinstance(w, dict) and "m" in w and "s" in w


def detect_tree_kind(params: Any) -> str:
    """"lm" or "cnn" — the param-tree convention detector."""
    if isinstance(params, dict) and (
            {"embed", "layers", "dec", "periods"} & set(params)):
        return "lm"
    return "cnn"


def _resolve(policy: Any, path: Optional[str]) -> Optional[BFPPolicy]:
    # Lazy import: engine.policy_map is reached through repro_torch.engine,
    # whose __init__ imports this module.
    from repro_torch.engine.policy_map import resolve_policy
    return resolve_policy(policy, path)


def prequant_leaf(w: torch.Tensor, policy: BFPPolicy) -> Any:
    """[.., K, N] float -> {"m": int8 [.., K, N], "s": f32 [.., K/bk, N]};
    a K that ``block_k`` does not divide stays float."""
    if w.ndim < 2:
        return w
    lead = w.shape[:-2]
    k, n = w.shape[-2:]
    bk = policy.block_k or k
    if k % bk:
        return w
    if w.numel() == 0:
        # an empty stack (the hybrid's periods below one period): the
        # sidecars of no matrix, in the dtypes a matrix would get
        one = prequant_leaf(w.new_zeros((k, n)), policy)
        return {"m": one["m"].new_empty((*lead, k, n)),
                "s": one["s"].new_empty((*lead, k // bk, n))}
    ms, ss = [], []
    for mat in w.reshape(-1, k, n):
        blk = bfp.bfp_quantize_matrix(mat, policy.l_w, "i", bfp.Scheme.TILED,
                                      bk, policy.rounding)
        ms.append(blk.mantissa)
        ss.append(bfp.pow2(blk.exponent - (policy.l_w - 2)))
    return {"m": torch.stack(ms).reshape(*lead, k, n),
            "s": torch.stack(ss).reshape(*lead, k // bk, n)}


def prequant_conv_leaf(w_hwio: torch.Tensor, policy: BFPPolicy) -> Any:
    """HWIO conv kernel -> prequant dict with the mantissa kept in HWIO
    and the steps in the GEMM view [K//bk, N]."""
    if w_hwio.ndim != 4:
        return w_hwio
    kh, kw, c, n = w_hwio.shape
    d = prequant_leaf(w_hwio.reshape(kh * kw * c, n), policy)
    if not is_prequant(d):
        return w_hwio          # block_k does not divide kh*kw*C
    return {"m": d["m"].reshape(kh, kw, c, n), "s": d["s"]}


def dequantize_prequant(w: Any, dtype=torch.float32) -> torch.Tensor:
    """Prequant dict ([.., K, N] mantissa, [.., K//bk, N] steps) back to
    a dense float weight; 4-D conv mantissas are lowered by the caller."""
    m, s = w["m"], w["s"]
    bk = m.shape[-2] // s.shape[-2]
    s_full = torch.repeat_interleave(s, bk, dim=-2)
    return m.to(dtype) * s_full.to(dtype)


def prequant_act(x: torch.Tensor, policy: BFPPolicy) -> Any:
    """Activations [.., K] -> {"m": int8 [.., K], "s": f32 [.., K//bk]}:
    blocks run along the LAST axis, one per (row, K-chunk).  Requires
    ``policy.l_i <= 8`` and ``block_k | K``."""
    k = x.shape[-1]
    bk = policy.block_k or k
    if k % bk:
        raise ValueError(f"activation prequant needs block_k | K, got "
                         f"block_k={bk}, K={k}")
    if policy.l_i > 8:
        raise ValueError(f"activation prequant streams int8 mantissas; "
                         f"L_I={policy.l_i} > 8")
    lead = x.shape[:-1]
    blk = bfp.bfp_quantize_matrix(x.reshape(-1, k), policy.l_i, "w",
                                  bfp.Scheme.TILED, bk, policy.rounding)
    return {"m": blk.mantissa.reshape(*lead, k),
            "s": bfp.pow2(blk.exponent - (policy.l_i - 2)).reshape(
                *lead, k // bk)}


def dequantize_act(x: Any, dtype=torch.float32) -> torch.Tensor:
    """Inverse layout of :func:`prequant_act` (blocks on the last axis)."""
    m, s = x["m"], x["s"]
    bk = m.shape[-1] // s.shape[-1]
    return m.to(dtype) * torch.repeat_interleave(s, bk, dim=-1).to(dtype)


def act_block(x: Any) -> int:
    """Block size of an activation-prequant dict (K // sidecar columns)."""
    return x["m"].shape[-1] // x["s"].shape[-1]


#: Leaf names that hold GEMM weights in LM trees: linear_init's "w" and
#: the MoE batched expert matrices.  Everything else (norm gains, biases,
#: embeddings — the gather path) stays float.
_GEMM_LEAF_NAMES = ("w", "w1", "w2", "w3")

#: Leading stack-container keys that runtime layer paths do not carry
#: (the layer loop passes "attn/wq", not "layers/attn/wq").  "enc" is
#: NOT stripped: encoder paths keep it.
_LM_STACK_PREFIXES = ("layers", "dec", "periods", "rem")


def lm_rule_path(keys) -> str:
    """Tree path (string keys) -> the runtime layer path PolicyMap rules
    see: the trailing "w" and the leading stack containers and indices
    are stripped, so "layers/attn/wq/w" resolves as "attn/wq".  MoE
    expert leaves keep their matrix name ("moe/w1" vs the runtime
    "moe"), so substring rules ("^moe") cover both."""
    ks = list(keys)
    if ks and ks[-1] == "w":
        ks = ks[:-1]
    while ks and (ks[0] in _LM_STACK_PREFIXES or ks[0].isdigit()):
        ks = ks[1:]
    return "/".join(ks)


def lm_eligible(keys) -> bool:
    """Is the LM leaf at ``keys`` a GEMM weight?  Routers (always float)
    and the embedding table are not."""
    if not keys or keys[-1] not in _GEMM_LEAF_NAMES:
        return False
    if len(keys) >= 2 and keys[-2] == "router":
        return False
    return "/".join(keys) != "embed/e"


def quantize_param_tree(params: Any, policy: Any) -> Any:
    """Walk an LM param tree; convert GEMM weights to the wire format.

    ``policy`` may be None (no-op), a BFPPolicy, or a PolicyMap (a rule
    resolving to None keeps that leaf float), matched against the same
    layer paths the runtime GEMMs use ("attn/wq", "ffn/w1", "lm_head").
    Stacked leaves ([L, K, N], or [L, E, K, N] MoE experts) quantize each
    trailing [K, N] matrix independently."""
    if policy is None:
        return params

    def one(path, leaf):
        keys = [str(k) for k in path]
        if not lm_eligible(keys):
            return leaf
        pol = _resolve(policy, lm_rule_path(keys))
        if pol is None:
            return leaf
        if isinstance(leaf, torch.Tensor) and leaf.ndim >= 2 and \
                leaf.is_floating_point():
            return prequant_leaf(leaf, pol)
        return leaf

    return _tree.map_with_path(one, params)


def _conv_bn_nested(params, rule_keys) -> bool:
    # The trailing "conv" segment is stripped ONLY for conv+bn blocks,
    # whose runtime layer path omits it (checked via the sibling "bn").
    node = params
    for kk in rule_keys[:-1]:
        node = node[int(kk)] if isinstance(node, (list, tuple)) \
            else node[kk]
    return isinstance(node.get(rule_keys[-1]), dict) and "bn" in node


def cnn_rule_path(params, keys) -> Optional[str]:
    """Runtime layer path for the CNN weight leaf at tree path ``keys``
    ("conv1_1", "fc6", "blocks/3/c1"), or None when the leaf is not a
    GEMM/conv weight (only leaves literally named ``w`` count)."""
    if not keys or keys[-1] != "w":
        return None
    rule_keys = keys[:-1]
    if rule_keys and rule_keys[-1] == "conv" and \
            _conv_bn_nested(params, rule_keys):
        rule_keys = rule_keys[:-1]
    return "/".join(rule_keys)


def quantize_cnn_param_tree(params: Any, policy: Any) -> Any:
    """Walk a CNN param tree into the wire format: 4-D HWIO conv kernels
    through :func:`prequant_conv_leaf`, 2-D dense weights through
    :func:`prequant_leaf`, with the policy resolved on each leaf's
    runtime layer path.  Biases and BN parameters stay as they are."""
    if policy is None:
        return params

    def one(path, leaf):
        keys = [str(k) for k in path]
        if not keys or keys[-1] != "w" or not isinstance(leaf, torch.Tensor):
            return leaf
        if not leaf.is_floating_point():
            return leaf
        pol = _resolve(policy, cnn_rule_path(params, keys))
        if pol is None:
            return leaf
        if leaf.ndim == 4:
            return prequant_conv_leaf(leaf, pol)
        if leaf.ndim == 2:
            return prequant_leaf(leaf, pol)
        return leaf

    return _tree.map_with_path(one, params)
