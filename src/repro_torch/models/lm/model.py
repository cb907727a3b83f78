"""Unified LM of the port (counterpart of ``repro.models.lm.model``): one
config-driven model covering every LM family of the reference:

  dense / vlm      {attn, swiglu} blocks (M-RoPE when configured)
  moe              {attn, moe} blocks (+ aux loss averaged over layers)
  ssm (rwkv6)      {time_mix, channel_mix} blocks
  hybrid (griffin) (rec, rec, attn) periods + a remainder of rec blocks
  audio (enc-dec)  an encoder stack, then a decoder stack with
                   cross-attention (seamless)

Layer stacks keep the reference's stacked layout: every leaf of
``params["layers"]`` (``"enc"``, ``"dec"``, ``"periods"``) is
``[L, ...]`` (MoE experts ``[L, E, K, N]``), and the hybrid's trailing
recurrent blocks are the list ``params["rem"]``, so a tree exported from
``repro`` loads unchanged (``convert``), and so do its prequant sidecars
and packed containers.  Where the reference scans over a stack, the port
runs a Python loop over the layer index, each layer taking its views of
the stacked leaves (one ``torch.unbind`` per leaf and forward).

The encoder-decoder is served through ``serve.engine.generate(
enc_feats=)`` (``prefill_encoder`` once, its output in the cache), as in
``repro``; ``ServeEngine`` serves every other family.

API:
  init_params(cfg, gen, device)                -> params tree
  forward(params, cfg, tokens, policy=...)     -> (logits, aux)
  init_cache(cfg, batch, max_len, device=...)  -> decode cache
  decode_step(params, cfg, cache, tok, pos, policy) -> (logits, cache)
  prefill_encoder(params, cfg, enc_feats, policy)   -> encoder output
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import _tree
from repro_torch import engine as EG
from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import LMConfig
from repro_torch.models.lm import common as C
from repro_torch.models.lm import griffin as G
from repro_torch.models.lm import moe as M
from repro_torch.models.lm import rwkv6 as R

__all__ = ["init_params", "param_count", "forward", "init_cache",
           "decode_step", "prefill_encoder"]

Policy = EG.PolicyLike


# ---------------------------------------------------------------------------
# Per-layer init / apply for each block kind (``lead``: the stack's shape)
# ---------------------------------------------------------------------------

def _attn_block_init(gen, cfg: LMConfig, lead, dev, cross: bool = False):
    d = cfg.d_model
    p = {"ln1": C.rmsnorm_init(d, lead=lead, device=dev),
         "attn": C.attention_init(gen, cfg, lead=lead, device=dev),
         "ln2": C.rmsnorm_init(d, lead=lead, device=dev)}
    if cfg.is_moe:
        p["moe"] = M.moe_init(gen, cfg, lead=lead, device=dev)
    else:
        p["ffn"] = C.swiglu_init(gen, d, cfg.d_ff, lead=lead, device=dev)
    if cross:
        p["lnx"] = C.rmsnorm_init(d, lead=lead, device=dev)
        p["xattn"] = C.attention_init(gen, cfg, lead=lead, device=dev)
    return p


def _ffn(lp, cfg: LMConfig, h, policy):
    """The block's second half: SwiGLU, or the MoE layer (with its aux)."""
    hn = C.rmsnorm(lp["ln2"], h, cfg.norm_eps)
    if cfg.is_moe:
        return M.moe_apply(lp["moe"], cfg, hn, policy)
    return C.swiglu(lp["ffn"], hn, policy, path="ffn"), None


def _attn_block(p, cfg: LMConfig, x, positions, policy, enc=None):
    # paths name COMPONENTS ("attn/wq", "ffn/w1"), not layer indices, as
    # the reference's scanned layers do: PolicyMap rules act per
    # component class across all layers
    x = x + C.attention(p["attn"], cfg, C.rmsnorm(p["ln1"], x, cfg.norm_eps),
                        positions, policy, path="attn")
    if enc is not None:
        x = x + C.attention(p["xattn"], cfg,
                            C.rmsnorm(p["lnx"], x, cfg.norm_eps), positions,
                            policy, xkv=enc, path="xattn")
    return x + C.swiglu(p["ffn"], C.rmsnorm(p["ln2"], x, cfg.norm_eps),
                        policy, path="ffn")


def _rwkv_block_init(gen, cfg: LMConfig, lead, dev):
    d = cfg.d_model
    return {"ln1": C.rmsnorm_init(d, lead=lead, device=dev),
            "tm": R.time_mix_init(gen, cfg, lead=lead, device=dev),
            "ln2": C.rmsnorm_init(d, lead=lead, device=dev),
            "cm": R.channel_mix_init(gen, cfg, lead=lead, device=dev)}


def _rwkv_block(p, cfg: LMConfig, x, policy):
    zero = torch.zeros((x.shape[0], x.shape[-1]), dtype=x.dtype,
                       device=x.device)
    x = x + R.time_mix(p["tm"], cfg, C.rmsnorm(p["ln1"], x, cfg.norm_eps),
                       zero, policy)
    return x + R.channel_mix(p["cm"], cfg,
                             C.rmsnorm(p["ln2"], x, cfg.norm_eps), zero,
                             policy)


def _rec_block_init(gen, cfg: LMConfig, lead, dev):
    d = cfg.d_model
    return {"ln1": C.rmsnorm_init(d, lead=lead, device=dev),
            "rec": G.rglru_block_init(gen, cfg, lead=lead, device=dev),
            "ln2": C.rmsnorm_init(d, lead=lead, device=dev),
            "ffn": C.swiglu_init(gen, d, cfg.d_ff, lead=lead, device=dev)}


def _rec_block(p, cfg: LMConfig, x, policy, state=None):
    y, new_state = G.rglru_block(p["rec"], cfg,
                                 C.rmsnorm(p["ln1"], x, cfg.norm_eps),
                                 state, policy)
    x = x + y
    x = x + C.swiglu(p["ffn"], C.rmsnorm(p["ln2"], x, cfg.norm_eps), policy,
                     path="ffn")
    return x, new_state


def _hybrid_layout(cfg: LMConfig):
    """(n_periods, remainder kinds): 38 = 12 x (rec, rec, attn) + (rec,
    rec)."""
    pat = cfg.block_pattern
    n_periods = cfg.n_layers // len(pat)
    rem = cfg.n_layers - n_periods * len(pat)
    return n_periods, pat[:rem]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: LMConfig, gen: torch.Generator,
                device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Seeded random params (architecture shapes only, no checkpoint),
    drawn from ``gen`` on its own device and placed on ``device``."""
    dev = resolve_device(device)
    d = cfg.d_model
    params: Dict[str, Any] = {"embed": C.embed_init(gen, cfg.vocab_size, d,
                                                    device=dev)}
    if cfg.is_encdec:
        params["enc"] = _attn_block_init(gen, cfg, (cfg.encoder_layers,),
                                         dev)
        params["dec"] = _attn_block_init(gen, cfg, (cfg.n_layers,), dev,
                                         cross=True)
        params["enc_ln"] = C.rmsnorm_init(d, device=dev)
    elif cfg.family == "ssm":
        params["layers"] = _rwkv_block_init(gen, cfg, (cfg.n_layers,), dev)
    elif cfg.block_pattern:
        n_periods, rem = _hybrid_layout(cfg)
        lead = (n_periods,)
        params["periods"] = {"rec1": _rec_block_init(gen, cfg, lead, dev),
                             "rec2": _rec_block_init(gen, cfg, lead, dev),
                             "attn": _attn_block_init(gen, cfg, lead, dev)}
        params["rem"] = [_rec_block_init(gen, cfg, (), dev) for _ in rem]
    else:
        params["layers"] = _attn_block_init(gen, cfg, (cfg.n_layers,), dev)
    params["ln_f"] = C.rmsnorm_init(d, device=dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = C.linear_init(gen, d, cfg.vocab_size,
                                          device=dev)
    return params


def param_count(params) -> int:
    return sum(x.numel() for x in _tree.flatten(params)[0])


def _layers(stacked):
    """(number of layers, layer i's params) of a stacked layer tree.

    Each ``[L, ...]`` leaf is unbound once into its L layer views: under
    autograd the backward of one ``unbind`` stacks the L layer
    gradients, where L ``t[i]`` selects would each write a zero
    ``[L, ...]`` tensor for the engine to add up (the same values; a
    -0.0 layer gradient stays -0.0 instead of becoming +0.0, which no
    optimizer state sees)."""
    leaves, treedef = _tree.flatten(stacked)
    n = leaves[0].shape[0] if leaves else 0
    views = [torch.unbind(t) for t in leaves]
    return n, lambda i: _tree.unflatten(treedef, [v[i] for v in views])


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------

def _embed(params, cfg: LMConfig, tokens: torch.Tensor) -> torch.Tensor:
    # the rows of ``embed`` (a gather, as indexing): its backward sums
    # repeated tokens deterministically on the CPU and the card, where
    # indexing's accumulating scatter varies from run to run on the CPU
    x = F.embedding(tokens, params["embed"]["e"])
    return (x * math.sqrt(float(cfg.d_model))).to(
        getattr(torch, cfg.compute_dtype))


def _unembed(params, cfg: LMConfig, x: torch.Tensor, policy: Policy):
    x = C.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return EG.gemm(x, params["embed"]["e"].t().to(x.dtype), policy,
                       path="lm_head")
    return C.linear(params["lm_head"], x, policy, path="lm_head")


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(
        b, s)


def _encode(params, cfg: LMConfig, enc: torch.Tensor, policy: Policy):
    """The encoder stack over frame embeddings [B, S_enc, D] (bidirectional
    self-attention, paths "enc/attn", "enc/ffn"), then its final norm."""
    enc_pos = _positions(enc.shape[0], enc.shape[1], enc.device)
    n, layer = _layers(params["enc"])
    for i in range(n):
        lp = layer(i)
        enc = C.attention(lp["attn"], cfg,
                          C.rmsnorm(lp["ln1"], enc, cfg.norm_eps), enc_pos,
                          policy, causal=False, path="enc/attn") + enc
        enc = enc + C.swiglu(lp["ffn"], C.rmsnorm(lp["ln2"], enc,
                                                  cfg.norm_eps),
                             policy, path="enc/ffn")
    return C.rmsnorm(params["enc_ln"], enc, cfg.norm_eps)


def forward(params, cfg: LMConfig, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            enc_feats: Optional[torch.Tensor] = None,
            policy: Policy = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (logits [B,S,V], aux_loss scalar).
    ``positions`` defaults to 0..S-1 per row (M-RoPE: [3, B, S] ids).
    ``enc_feats``: [B, S_enc, D] frame embeddings of the encoder-decoder
    (None: a zero stub of ``cfg.enc_seq_stub`` frames)."""
    b, s = tokens.shape
    if positions is None:
        positions = _positions(b, s, tokens.device)
    x = _embed(params, cfg, tokens)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    if cfg.is_encdec:
        enc = enc_feats if enc_feats is not None else torch.zeros(
            (b, cfg.enc_seq_stub, cfg.d_model), dtype=x.dtype,
            device=x.device)
        enc = _encode(params, cfg, enc, policy)
        n, layer = _layers(params["dec"])
        for i in range(n):
            x = _attn_block(layer(i), cfg, x, positions, policy, enc=enc)
        return _unembed(params, cfg, x, policy), aux

    if cfg.family == "ssm":
        n, layer = _layers(params["layers"])
        for i in range(n):
            x = _rwkv_block(layer(i), cfg, x, policy)
        return _unembed(params, cfg, x, policy), aux

    if cfg.block_pattern:
        n, period = _layers(params["periods"])
        for i in range(n):
            lp = period(i)
            x, _ = _rec_block(lp["rec1"], cfg, x, policy)
            x, _ = _rec_block(lp["rec2"], cfg, x, policy)
            x = _attn_block(lp["attn"], cfg, x, positions, policy)
        for rp in params["rem"]:
            x, _ = _rec_block(rp, cfg, x, policy)
        return _unembed(params, cfg, x, policy), aux

    n, layer = _layers(params["layers"])
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
# decode (KV cache / recurrent state)
# ---------------------------------------------------------------------------

def init_cache(cfg: LMConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Decode cache, the slot axis at dim 1 of every leaf.  Attention KV
    buffers ``{"k", "v"}`` of [L, B, T, Hk, Dh] in ``dtype`` are ring
    buffers of T = min(max_len, sliding_window) for SWA (vLLM-style);
    the recurrent families carry constant-size f32 states (the hybrid's
    conv history in ``dtype``); the encoder-decoder's ``"enc_out"`` is
    None until ``prefill`` runs the encoder."""
    dev = resolve_device(device)
    t = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    hk, dh, d = cfg.n_kv_heads, cfg.dh, cfg.d_model
    f32 = torch.float32

    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=dev)

    def kv(n):
        return {"k": zeros((n, batch, t, hk, dh), dtype),
                "v": zeros((n, batch, t, hk, dh), dtype)}

    if cfg.is_encdec:
        return {"self": kv(cfg.n_layers), "enc_out": None}
    if cfg.family == "ssm":
        n, h = cfg.n_layers, cfg.n_heads
        return {"x_att": zeros((n, batch, d), f32),
                "x_ffn": zeros((n, batch, d), f32),
                "S": zeros((n, batch, h, dh, dh), f32)}
    if cfg.block_pattern:
        n_periods, rem = _hybrid_layout(cfg)
        lw = cfg.lru_width or d

        def rec(n):
            return {"h": zeros((n, batch, lw), f32),
                    "hist": zeros((n, batch, cfg.conv_width - 1, lw), dtype)}

        return {"rec1": rec(n_periods), "rec2": rec(n_periods),
                "attn": kv(n_periods), "rem": rec(len(rem))}
    return kv(cfg.n_layers)


def _stack(steps, empty):
    """The per-layer outputs ``steps`` stacked on a new dim 0, or, for a
    stack of no layer, ``empty`` (what a scan over zero layers returns)."""
    return torch.stack(steps) if steps else empty


def decode_step(params, cfg: LMConfig, cache, tokens: torch.Tensor,
                pos, policy: Policy = None) -> Tuple[torch.Tensor, Any]:
    """One decode step.  tokens: [B, 1]; pos: the current index (an int
    or a 0-d tensor), the same for every row.

    Returns (logits [B, 1, V], the updated cache — new tensors: the
    given cache is left as it was)."""
    pos = int(pos)
    x = _embed(params, cfg, tokens)
    b = tokens.shape[0]

    if cfg.is_encdec:
        # no cross-attention K/V cache: every step projects all encoder
        # frames; with no encoder output the cross block attends to x
        enc = cache["enc_out"]
        xpos = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
        n, layer = _layers(params["dec"])
        ks, vs = [], []
        for i in range(n):
            lp = layer(i)
            y, k2, v2 = C.attention_decode(
                lp["attn"], cfg, C.rmsnorm(lp["ln1"], x, cfg.norm_eps), pos,
                cache["self"]["k"][i], cache["self"]["v"][i], policy,
                path="attn")
            x = x + y
            x = x + C.attention(lp["xattn"], cfg,
                                C.rmsnorm(lp["lnx"], x, cfg.norm_eps), xpos,
                                policy, xkv=enc, path="xattn")
            x = x + C.swiglu(lp["ffn"], C.rmsnorm(lp["ln2"], x, cfg.norm_eps),
                             policy, path="ffn")
            ks.append(k2)
            vs.append(v2)
        new = dict(cache, self={"k": _stack(ks, cache["self"]["k"]),
                                "v": _stack(vs, cache["self"]["v"])})
        return _unembed(params, cfg, x, policy), new

    if cfg.family == "ssm":
        n, layer = _layers(params["layers"])
        xa, xf, ss = [], [], []
        for i in range(n):
            lp = layer(i)
            y, (xa2, s2) = R.time_mix_decode(
                lp["tm"], cfg, C.rmsnorm(lp["ln1"], x, cfg.norm_eps),
                (cache["x_att"][i], cache["S"][i]))
            x = x + y
            y, xf2 = R.channel_mix_decode(
                lp["cm"], cfg, C.rmsnorm(lp["ln2"], x, cfg.norm_eps),
                cache["x_ffn"][i])
            x = x + y
            xa.append(xa2)
            xf.append(xf2)
            ss.append(s2)
        return _unembed(params, cfg, x, policy), {
            "x_att": _stack(xa, cache["x_att"]),
            "x_ffn": _stack(xf, cache["x_ffn"]), "S": _stack(ss, cache["S"])}

    if cfg.block_pattern:
        return _hybrid_decode(params, cfg, cache, x, pos, policy)

    # dense / vlm / moe
    n, layer = _layers(params["layers"])
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
            {"k": _stack(ks, cache["k"]), "v": _stack(vs, cache["v"])})


def _hybrid_decode(params, cfg: LMConfig, cache, x, pos: int,
                   policy: Policy):
    """The hybrid's decode step: the periods, then the remainder blocks.
    A recurrent block's new conv history comes back f32 (the bf16 cache
    promoted by the concatenation, as in the reference), and so does an
    empty stack of periods; an empty remainder keeps its cache as it
    was."""
    def rec_step(lp, h, st):
        y, st2 = G.rglru_block_decode(
            lp["rec"], cfg, C.rmsnorm(lp["ln1"], h, cfg.norm_eps), st,
            policy)
        h = h + y
        h = h + C.swiglu(lp["ffn"], C.rmsnorm(lp["ln2"], h, cfg.norm_eps),
                         policy, path="ffn")
        return h, st2

    n, period = _layers(params["periods"])
    outs = {k: [] for k in ("r1h", "r1x", "r2h", "r2x", "k", "v")}
    for i in range(n):
        lp = period(i)
        x, (h1, x1) = rec_step(lp["rec1"], x, (cache["rec1"]["h"][i],
                                               cache["rec1"]["hist"][i]))
        x, (h2, x2) = rec_step(lp["rec2"], x, (cache["rec2"]["h"][i],
                                               cache["rec2"]["hist"][i]))
        ap = lp["attn"]
        y, k2, v2 = C.attention_decode(
            ap["attn"], cfg, C.rmsnorm(ap["ln1"], x, cfg.norm_eps), pos,
            cache["attn"]["k"][i], cache["attn"]["v"][i], policy,
            path="attn")
        x = x + y
        x = x + C.swiglu(ap["ffn"], C.rmsnorm(ap["ln2"], x, cfg.norm_eps),
                         policy, path="ffn")
        for key, t in zip(outs, (h1, x1, h2, x2, k2, v2)):
            outs[key].append(t)

    def hist_dtype(hist):
        return torch.promote_types(hist.dtype, x.dtype)

    f32 = torch.float32
    r1, r2 = cache["rec1"], cache["rec2"]
    new = {"rec1": {"h": _stack(outs["r1h"], r1["h"].to(f32)),
                    "hist": _stack(outs["r1x"],
                                   r1["hist"].to(hist_dtype(r1["hist"])))},
           "rec2": {"h": _stack(outs["r2h"], r2["h"].to(f32)),
                    "hist": _stack(outs["r2x"],
                                   r2["hist"].to(hist_dtype(r2["hist"])))},
           "attn": {"k": _stack(outs["k"], cache["attn"]["k"]),
                    "v": _stack(outs["v"], cache["attn"]["v"])}}
    rem_h, rem_hist = [], []
    for i, rp in enumerate(params["rem"]):
        x, (h2, hist2) = rec_step(rp, x, (cache["rem"]["h"][i],
                                          cache["rem"]["hist"][i]))
        rem_h.append(h2)
        rem_hist.append(hist2)
    new["rem"] = {"h": _stack(rem_h, cache["rem"]["h"]),
                  "hist": _stack(rem_hist, cache["rem"]["hist"])}
    return _unembed(params, cfg, x, policy), new


def prefill_encoder(params, cfg: LMConfig, enc_feats: torch.Tensor,
                    policy: Policy = None) -> torch.Tensor:
    """Run the encoder once (enc-dec serving); ``serve.engine.prefill``
    puts the result into the cache as ``"enc_out"``."""
    return _encode(params, cfg, enc_feats, policy)
