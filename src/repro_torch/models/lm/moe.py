"""Mixture-of-Experts layer of the port (counterpart of
``repro.models.lm.moe``): mixtral 8e top-2, olmoe 64e top-8.

Sort-based capacity dispatch, as in the reference:

  1. router top-k per token (the router runs in float whatever the
     policy),
  2. sort (token, k) slots by expert id (stable), position-in-expert by
     running offset, drop beyond capacity C = int(T*K/E * capacity_factor
     + 1),
  3. gather into [E, C, D], batched expert GEMMs,
  4. weighted combine back to [T, D].

The expert GEMMs run the EMULATED integer datapath (``core.bfp_dot``'s
arithmetic) whatever the backend, as the reference's vmapped
``bfp_matmul_2d[_prequant]`` does: each expert's matrix keeps its own
block exponents.  Under a TILED policy all experts run as one batched
computation (bit-equal to one call per expert, since every block lies
inside one expert); other schemes, and STOCHASTIC rounding, call the
per-expert datapath once per expert.  Gradients are the reference's:
with ``policy.straight_through`` the batched computation is the
straight-through estimator of ``bfp_matmul_2d`` per expert (float
gradients over the dequantized operands); without it the integer
mantissas carry none, and the expert weights get zeros, as
differentiating through ``repro``'s quantizer gives.  Prequant experts
have no gradient.

Selection and combine are deterministic: top-k by a stable descending
sort (the lower expert index first on ties, as ``lax.top_k``), and each
token's k contributions summed in the reference's sorted order (no
atomics).  The dispatch's index arithmetic (``_route``) and the gather,
experts and combine it steers (``_experts``) are separate functions, so
that ``roofline.partition`` can split the second over a mesh and run the
first, global over the tokens, on every device.  The reference's
``shard`` annotations stand on the expert buffers and the expert hidden
(``dist.sharding``: the identity outside a binding and on plain
tensors).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch import engine as EG
from repro_torch.configs.base import LMConfig
from repro_torch.core import bfp
from repro_torch.core.bfp import Rounding, Scheme
from repro_torch.core.bfp_dot import (_check_tile, _exact_dot, _sum_in_order,
                                      bfp_matmul_2d, bfp_matmul_2d_prequant)
from repro_torch.core.prequant import dequantize_prequant, is_prequant
from repro_torch.dist.sharding import shard
from repro_torch.models.lm.common import linear_init, normal

__all__ = ["moe_init", "moe_apply"]

Policy = EG.PolicyLike


def moe_init(gen: torch.Generator, cfg: LMConfig, *, lead=(),
             device: torch.device):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": linear_init(gen, d, e, lead=lead, device=device),
        "w1": normal(gen, (*lead, e, d, f), (1.0 / d) ** 0.5, device),
        "w3": normal(gen, (*lead, e, d, f), (1.0 / d) ** 0.5, device),
        "w2": normal(gen, (*lead, e, f, d), (1.0 / f) ** 0.5, device),
    }


def _batched_tiled(xe: torch.Tensor, we, policy) -> torch.Tensor:
    """The TILED datapath of every expert at once: x blocks per (row,
    K-tile), w blocks per (column, K-tile) of each expert (formatted here
    or read from the sidecar), the exact int dot per K-tile and the f32
    sum over K-tiles in tile order — ``bfp_matmul_2d`` /
    ``bfp_matmul_2d_prequant`` per expert, element for element."""
    e, c, k = xe.shape
    if is_prequant(we):
        t = we["s"].shape[-2]
        bk = k // t
        if policy.block_k not in (None, bk):
            raise ValueError(f"policy.block_k={policy.block_k} != prequant "
                             f"block {bk}")
        n = we["m"].shape[-1]
        mw = we["m"].reshape(e, t, bk, n)
        sw = we["s"][:, :, None, :]                          # [E,t,1,N]
    else:
        bk = policy.block_k or k
        t, n = k // bk, we.shape[-1]
        bw = bfp.quantize(we.reshape(e, t, bk, n), policy.l_w, (2,),
                          policy.rounding)
        mw = bw.mantissa
        sw = bfp.pow2(bw.exponent - (policy.l_w - 2)).reshape(e, t, 1, n)
    _check_tile(bk, policy, "block_k")
    bx = bfp.bfp_quantize_matrix(xe.reshape(e * c, k), policy.l_i, "w",
                                 Scheme.TILED, bk, policy.rounding)
    mx = bx.mantissa.reshape(e, c, t, bk).transpose(1, 2)    # [E,t,C,bk]
    sx = bfp.pow2(bx.exponent - (policy.l_i - 2)).reshape(
        e, c, t).transpose(1, 2)[..., None]                  # [E,t,C,1]
    part = _exact_dot(mx, mw)                                # [E,t,C,N]
    return _sum_in_order((part * sx * sw).transpose(0, 1))


class _BatchedTiledSTE(torch.autograd.Function):
    """:func:`_batched_tiled` with ``core.bfp_dot._BfpMatmulSTE``'s
    gradients per expert: ``g @ wq.T`` and ``xq.T @ g`` over the operands
    dequantized as the forward formats them (x per (row, K-tile), w per
    (column, K-tile) of each expert)."""

    @staticmethod
    def forward(ctx, xe, we, policy):
        ctx.policy = policy
        ctx.save_for_backward(xe, we)
        return _batched_tiled(xe, we, policy)

    @staticmethod
    def backward(ctx, g):
        xe, we = ctx.saved_tensors
        pol = ctx.policy
        e, c, k = xe.shape
        bk, n = pol.block_k or k, we.shape[-1]
        xq = bfp.bfp_quantize_matrix(
            xe.reshape(e * c, k), pol.l_i, "w", Scheme.TILED, bk,
            pol.rounding).dequantize().reshape(e, c, k)
        wq = bfp.quantize(we.reshape(e, k // bk, bk, n), pol.l_w, (2,),
                          pol.rounding).dequantize().reshape(e, k, n)
        return g @ wq.transpose(1, 2), xq.transpose(1, 2) @ g, None


def _expert_gemm(xe: torch.Tensor, we, policy) -> torch.Tensor:
    """[E, C, d_in] x [E, d_in, d_out] -> [E, C, d_out], BFP per expert.

    ``policy`` is a concrete BFPPolicy or None (``moe_apply`` resolves
    maps and plans first); ``we`` may be the prequant wire format with a
    leading expert dim ({"m": [E, d_in, d_out], "s": [E, d_in/bk,
    d_out]})."""
    if policy is None:
        w = dequantize_prequant(we, xe.dtype) if is_prequant(we) \
            else we.to(xe.dtype)
        return torch.einsum("ecd,edf->ecf", xe, w)
    t = we["s"].shape[-2] if is_prequant(we) else None
    if (policy.scheme is Scheme.TILED and policy.rounding is not
            Rounding.STOCHASTIC and policy.quantize_inputs
            and (policy.quantize_weights or t is not None) and t != 1):
        if (policy.straight_through and t is None
                and torch.is_grad_enabled()
                and (xe.requires_grad or we.requires_grad)):
            return _BatchedTiledSTE.apply(xe, we, policy)
        return _batched_tiled(xe, we, policy)
    if is_prequant(we):
        return torch.stack([bfp_matmul_2d_prequant(a, m, s, policy)
                            for a, m, s in zip(xe, we["m"], we["s"])])
    return torch.stack([bfp_matmul_2d(a, w, policy)
                        for a, w in zip(xe, we)])


def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k``: the k largest per row, lower index first on ties."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], ids[:, :k]


def _route(expert_ids: torch.Tensor, gate_vals: torch.Tensor, e: int,
           cap: int) -> Tuple[torch.Tensor, ...]:
    """The sort-based dispatch's index arithmetic, global over the T
    tokens: (sorted_tok, sorted_gate, keep, slot, by_token), each [T*K]
    but ``by_token`` [T, K]: the (token, k) slots sorted by expert id
    (stable), their gates, whether each fits its expert's capacity
    ``cap``, its row in the [E*C + 1] expert buffer (E*C: the drop
    bucket) and each token's k positions in that sorted order."""
    t, k = expert_ids.shape
    dev = expert_ids.device
    flat_expert = expert_ids.reshape(-1)                          # [T*K]
    flat_token = torch.arange(t, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_expert, stable=True)
    sorted_e = flat_expert[order]
    sorted_tok = flat_token[order]
    sorted_gate = gate_vals.reshape(-1)[order]
    seg_start = torch.searchsorted(sorted_e, torch.arange(e, device=dev))
    pos_in_e = torch.arange(t * k, device=dev) - seg_start[sorted_e]
    keep = pos_in_e < cap
    slot = torch.where(keep, sorted_e * cap + pos_in_e,
                       torch.full_like(pos_in_e, e * cap))   # drop bucket
    rank = torch.empty_like(order)
    rank[order] = torch.arange(t * k, device=dev)
    by_token = torch.sort(rank.reshape(t, k), dim=1).values      # [T, K]
    return sorted_tok, sorted_gate, keep, slot, by_token


def _experts(p, x: torch.Tensor, route, e: int, cap: int, policy
             ) -> torch.Tensor:
    """Gather the tokens of x [B, S, D] into the expert buffers by
    ``route`` (:func:`_route`), run the SwiGLU experts, and combine each
    token's k contributions in sorted order -> [B, S, D]."""
    sorted_tok, sorted_gate, keep, slot, by_token = route
    b, s, d = x.shape
    t, k = b * s, by_token.shape[1]
    dev = x.device
    xt = x.reshape(t, d)

    # gather tokens into expert buffers [E*C+1, D] (last row = drop bucket)
    buf = torch.zeros((e * cap + 1, d), dtype=xt.dtype, device=dev)
    buf[slot] = F.embedding(sorted_tok, xt)   # xt[sorted_tok], as _embed
    xe = buf[:-1].reshape(e, cap, d)
    xe = shard(xe, "experts", None, None)

    # ---- expert FFN (SwiGLU) ----------------------------------------------
    h = F.silu(_expert_gemm(xe, p["w1"], policy)) * \
        _expert_gemm(xe, p["w3"], policy)
    h = shard(h, "experts", None, "ffn")
    ye = _expert_gemm(h, p["w2"], policy)                        # [E, C, D]

    # ---- combine: each token's k contributions in sorted order ------------
    yflat = ye.reshape(e * cap, d)
    contrib = torch.where(keep[:, None],
                          yflat[torch.clamp(slot, max=e * cap - 1)],
                          torch.zeros((), dtype=yflat.dtype, device=dev)) \
        * sorted_gate[:, None]
    out = torch.zeros((t, d), dtype=x.dtype, device=dev)
    for j in range(k):
        out = out + contrib[by_token[:, j]].to(x.dtype)
    return out.reshape(b, s, d)


def moe_apply(p, cfg: LMConfig, x: torch.Tensor, policy: Policy = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (out [B, S, D], aux_loss scalar)."""
    # per-layer maps and plans resolve once for the expert GEMMs (path
    # "moe"); the router always runs in float
    policy = EG.resolve_policy(policy, "moe")
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    dev = x.device
    xt = x.reshape(t, d)

    logits = EG.gemm(xt, p["router"]["w"], None)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)       # [T, E]
    gate_vals, expert_ids = _top_k(probs, k)                      # [T, K]
    gate_vals = gate_vals / torch.sum(gate_vals, -1, keepdim=True)

    # load-balance aux loss (Switch): E * sum_e fraction_e * prob_e
    density = torch.mean((expert_ids[:, :1] == torch.arange(
        e, device=dev)).to(torch.float32), dim=0)      # one_hot, on device
    aux = e * torch.sum(density * torch.mean(probs, dim=0))

    cap = int(t * k / e * cfg.capacity_factor + 1)
    return _experts(p, x, _route(expert_ids, gate_vals, e, cap), e, cap,
                    policy), aux

