"""Unified LM of the port (counterpart of ``repro.models.lm.model``) for
the attention families:

  dense / vlm   {attn, swiglu} blocks (M-RoPE when configured)
  moe           {attn, moe} blocks (+ aux loss averaged over layers)

The layer stack keeps the reference's stacked layout: every leaf of
``params["layers"]`` is ``[L, ...]`` (MoE experts ``[L, E, K, N]``), so
a tree exported from ``repro`` loads unchanged (``convert``), and so do
its prequant sidecars and packed containers.  Where the reference scans
over the stack, the port runs a Python loop over the layer index, each
layer taking ``tree_map(lambda t: t[i], stacked)``.  The recurrent
families (ssm: rwkv6, hybrid: griffin) and the encoder-decoder
(seamless) raise ``NotImplementedError`` until their slice (ROADMAP
Queue 1).

API:
  init_params(cfg, gen, device)                -> params tree
  forward(params, cfg, tokens, policy=...)     -> (logits, aux)
  init_cache(cfg, batch, max_len, device=...)  -> decode cache
  decode_step(params, cfg, cache, tok, pos, policy) -> (logits, cache)
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import _tree
from repro_torch import engine as EG
from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import LMConfig
from repro_torch.models.lm import common as C
from repro_torch.models.lm import moe as M

__all__ = ["init_params", "param_count", "forward", "init_cache",
           "decode_step"]

Policy = EG.PolicyLike


def _check_family(cfg: LMConfig) -> None:
    if cfg.is_encdec or cfg.family == "ssm" or cfg.block_pattern:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}{', enc-dec' if cfg.is_encdec else ''})"
            f": the recurrent families (rwkv6, griffin) and the "
            f"encoder-decoder are the next LM slice (ROADMAP Queue 1); "
            f"this one serves dense, vlm and moe")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: LMConfig, gen: torch.Generator,
                device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Seeded random params (architecture shapes only, no checkpoint),
    drawn from ``gen`` on its own device and placed on ``device``."""
    _check_family(cfg)
    dev = resolve_device(device)
    n, d = (cfg.n_layers,), cfg.d_model
    params: Dict[str, Any] = {"embed": C.embed_init(gen, cfg.vocab_size, d,
                                                    device=dev)}
    layers = {"ln1": C.rmsnorm_init(d, lead=n, device=dev),
              "attn": C.attention_init(gen, cfg, lead=n, device=dev),
              "ln2": C.rmsnorm_init(d, lead=n, device=dev)}
    if cfg.is_moe:
        layers["moe"] = M.moe_init(gen, cfg, lead=n, device=dev)
    else:
        layers["ffn"] = C.swiglu_init(gen, d, cfg.d_ff, lead=n, device=dev)
    params["layers"] = layers
    params["ln_f"] = C.rmsnorm_init(d, device=dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = C.linear_init(gen, d, cfg.vocab_size,
                                          device=dev)
    return params


def param_count(params) -> int:
    return sum(x.numel() for x in _tree.flatten(params)[0])


def _layers(params):
    """(number of layers, layer i's params) of the stacked layer tree."""
    stacked = params["layers"]
    n = _tree.flatten(stacked)[0][0].shape[0]
    return n, lambda i: _tree.tree_map(lambda t: t[i], stacked)


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------

def _embed(params, cfg: LMConfig, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"]["e"][tokens]
    return (x * math.sqrt(float(cfg.d_model))).to(
        getattr(torch, cfg.compute_dtype))


def _unembed(params, cfg: LMConfig, x: torch.Tensor, policy: Policy):
    x = C.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return EG.gemm(x, params["embed"]["e"].t().to(x.dtype), policy,
                       path="lm_head")
    return C.linear(params["lm_head"], x, policy, path="lm_head")


def _ffn(lp, cfg: LMConfig, h, policy):
    """The block's second half: SwiGLU, or the MoE layer (with its aux)."""
    hn = C.rmsnorm(lp["ln2"], h, cfg.norm_eps)
    if cfg.is_moe:
        return M.moe_apply(lp["moe"], cfg, hn, policy)
    return C.swiglu(lp["ffn"], hn, policy, path="ffn"), None


def forward(params, cfg: LMConfig, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            enc_feats: Optional[torch.Tensor] = None,
            policy: Policy = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (logits [B,S,V], aux_loss scalar).
    ``positions`` defaults to 0..S-1 per row (M-RoPE: [3, B, S] ids)."""
    _check_family(cfg)
    if enc_feats is not None:
        raise NotImplementedError("enc_feats: the encoder-decoder is the "
                                  "next LM slice (ROADMAP Queue 1)")
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device)[None].expand(b, s)
    x = _embed(params, cfg, tokens)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    n, layer = _layers(params)
    for i in range(n):
        lp = layer(i)
        x = x + C.attention(lp["attn"], cfg,
                            C.rmsnorm(lp["ln1"], x, cfg.norm_eps),
                            positions, policy, path="attn")
        y, aux_l = _ffn(lp, cfg, x, policy)
        x = x + y
        if aux_l is not None:
            aux = aux + aux_l
    if cfg.is_moe:
        aux = aux / cfg.n_layers
    return _unembed(params, cfg, x, policy), aux


# ---------------------------------------------------------------------------
# decode (KV cache)
# ---------------------------------------------------------------------------

def init_cache(cfg: LMConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Decode cache: ``{"k", "v"}`` of [L, B, T, Hk, Dh] in bf16, ring
    buffers of T = min(max_len, sliding_window) for SWA (vLLM-style)."""
    _check_family(cfg)
    dev = resolve_device(device)
    t = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    shape = (cfg.n_layers, batch, t, cfg.n_kv_heads, cfg.dh)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def decode_step(params, cfg: LMConfig, cache, tokens: torch.Tensor,
                pos, policy: Policy = None) -> Tuple[torch.Tensor, Any]:
    """One decode step.  tokens: [B, 1]; pos: the current index (an int
    or a 0-d tensor), the same for every row.

    Returns (logits [B, 1, V], the updated cache — new tensors: the
    given cache is left as it was)."""
    _check_family(cfg)
    pos = int(pos)
    x = _embed(params, cfg, tokens)
    n, layer = _layers(params)
    ks, vs = [], []
    for i in range(n):
        lp = layer(i)
        y, k2, v2 = C.attention_decode(
            lp["attn"], cfg, C.rmsnorm(lp["ln1"], x, cfg.norm_eps), pos,
            cache["k"][i], cache["v"][i], policy, path="attn")
        x = x + y
        x = x + _ffn(lp, cfg, x, policy)[0]
        ks.append(k2)
        vs.append(v2)
    return (_unembed(params, cfg, x, policy),
            {"k": torch.stack(ks), "v": torch.stack(vs)})
