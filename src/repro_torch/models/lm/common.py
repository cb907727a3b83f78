"""Shared transformer components of the port (counterpart of
``repro.models.lm.common``): RMSNorm, RoPE (+ M-RoPE), GQA attention
(full / flash / sliding-window, and single-token KV-cache decode),
SwiGLU FFN.

Every linear routes through :func:`repro_torch.engine.gemm` on the
reference's layer paths ("attn/wq", "ffn/w1", "lm_head"), so ``policy``
may be None (float), a BFPPolicy, a PolicyMap or a bound Plan, and
prequantized ``{"m", "s"}`` weights feed the integer datapath as they
are.  Everything else here is plain float math on tensors, as in the
reference (einsums, not kernels); attention is written out in the
reference's order of operations rather than calling
``scaled_dot_product_attention``, whose numerics differ.  The
reference's ``dist.sharding.shard`` annotations have no mesh to act on
until the dist slice and are left out.

Initializers draw from an explicit ``torch.Generator`` on its own device
and place the result on ``device``; a leading ``lead`` shape stacks one
draw per layer (the reference's ``[L, ...]`` layout).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import engine as EG
from repro_torch.configs.base import LMConfig
from repro_torch.engine import PolicyLike, join_path

__all__ = ["rmsnorm", "rmsnorm_init", "rope", "mrope", "attention_init",
           "attention", "attention_decode", "swiglu_init", "swiglu",
           "linear_init", "linear", "embed_init", "FLASH_THRESHOLD"]

Policy = PolicyLike
Shape = Tuple[int, ...]


def scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a 0-d tensor of ``like``'s dtype and device (a fill, no
    host copy).  ``torch.maximum`` / ``torch.minimum`` against it give
    the same values as ``torch.clamp``, and at a tie split the gradient
    0.5 / 0.5 as ``jnp.maximum`` / ``jnp.clip`` do (``torch.clamp``
    passes all of it)."""
    return like.new_full((), v)


def normal(gen: torch.Generator, shape: Shape, scale: float,
           device: torch.device) -> torch.Tensor:
    """N(0, 1) * ``scale``, drawn on the generator's device."""
    w = torch.randn(shape, generator=gen, device=gen.device) * scale
    return w.to(device)


def _init(gen, shape, fan_in: int, device) -> torch.Tensor:
    return normal(gen, shape, math.sqrt(1.0 / fan_in), device)


def linear_init(gen: torch.Generator, d_in: int, d_out: int,
                bias: bool = False, *, lead: Shape = (),
                device: torch.device):
    p = {"w": _init(gen, (*lead, d_in, d_out), d_in, device)}
    if bias:
        p["b"] = torch.zeros((*lead, d_out), device=device)
    return p


def linear(p, x: torch.Tensor, policy: Policy = None,
           path: Optional[str] = None) -> torch.Tensor:
    w = p["w"]
    if not EG.is_prequant(w):
        w = w.to(x.dtype)            # params fp32, compute in x.dtype
    y = EG.gemm(x, w, policy, path=path)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def rmsnorm_init(d: int, *, lead: Shape = (), device: torch.device):
    return {"g": torch.ones((*lead, d), device=device)}


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * p["g"]).to(x.dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, *,
               device: torch.device):
    return {"e": normal(gen, (vocab, d), 0.02, device)}


# ---------------------------------------------------------------------------
# Rotary embeddings (standard + qwen2-vl M-RoPE)
# ---------------------------------------------------------------------------

def _rope_freqs(dh: int, theta: float, device) -> torch.Tensor:
    i = torch.arange(0, dh // 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (i / (dh // 2)))


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, Dh] rotated by angles [B, S, Dh/2] (split halves)."""
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin,
                      x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: [B, S, H, Dh]; positions: [B, S] integer."""
    freqs = _rope_freqs(x.shape[-1], theta, x.device)           # [Dh/2]
    return _rotate(x, positions[..., None].to(torch.float32) * freqs)


def mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
          sections: Tuple[int, int, int]) -> torch.Tensor:
    """qwen2-vl multimodal RoPE: positions3 [3, B, S] = (t, h, w) ids.

    The Dh/2 rotary frequencies are partitioned into (temporal, height,
    width) sections; each section rotates by its own position stream
    (the reference's one-hot contraction, taken as the selection it
    is).  For text tokens the three streams coincide: standard RoPE."""
    dh = x.shape[-1]
    freqs = _rope_freqs(dh, theta, x.device)
    ang_3 = positions3[..., None].to(torch.float32) * freqs  # [3,B,S,Dh/2]
    # the section of each frequency (np.repeat(arange(3), sections)),
    # computed on the device
    i = torch.arange(dh // 2, device=x.device)
    sec = (i >= sections[0]).long() + (i >= sections[0] + sections[1]).long()
    ang = torch.gather(ang_3.permute(1, 2, 3, 0), -1,
                       sec.expand(*ang_3.shape[1:])[..., None])[..., 0]
    return _rotate(x, ang)


def _apply_rope(cfg: LMConfig, x, positions):
    if cfg.mrope_sections is not None:
        if positions.ndim == 2:   # text-only: all three streams equal
            positions = positions[None].expand(3, *positions.shape)
        return mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    return rope(x, positions, cfg.rope_theta)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

def attention_init(gen: torch.Generator, cfg: LMConfig, *, lead: Shape = (),
                   device: torch.device):
    d, dh, h, hk = cfg.d_model, cfg.dh, cfg.n_heads, cfg.n_kv_heads
    kw = dict(lead=lead, device=device)
    return {"wq": linear_init(gen, d, h * dh, cfg.qkv_bias, **kw),
            "wk": linear_init(gen, d, hk * dh, cfg.qkv_bias, **kw),
            "wv": linear_init(gen, d, hk * dh, cfg.qkv_bias, **kw),
            "wo": linear_init(gen, h * dh, d, **kw)}


def _qkv(p, cfg: LMConfig, x, xkv, policy: Policy, path=None):
    b, s, skv = x.shape[0], x.shape[1], xkv.shape[1]
    q = linear(p["wq"], x, policy,
               join_path(path, "wq")).reshape(b, s, cfg.n_heads, cfg.dh)
    k = linear(p["wk"], xkv, policy,
               join_path(path, "wk")).reshape(b, skv, cfg.n_kv_heads, cfg.dh)
    v = linear(p["wv"], xkv, policy,
               join_path(path, "wv")).reshape(b, skv, cfg.n_kv_heads, cfg.dh)
    return q, k, v


def _scale(dh: int, like: torch.Tensor) -> torch.Tensor:
    """sqrt(Dh) as an f32 tensor on ``like``'s device (a divide by a
    tensor, as the reference divides by ``jnp.sqrt(dh)``; filled on the
    device, so no host copy waits for the queue)."""
    return torch.sqrt(torch.full((), float(dh), dtype=torch.float32,
                                 device=like.device))


def _softcap(scores, cfg: LMConfig):
    if cfg.attn_logit_softcap:
        c = cfg.attn_logit_softcap
        scores = torch.tanh(scores / c) * c
    return scores


def _sdpa(q, k, v, cfg: LMConfig, mask: Optional[torch.Tensor]
          ) -> torch.Tensor:
    """Grouped scaled dot-product attention.  q:[B,S,H,Dh] k,v:[B,T,Hk,Dh]."""
    b, s, h, dh = q.shape
    hk = k.shape[2]
    g = h // hk
    qg = q.reshape(b, s, hk, g, dh)
    scores = torch.einsum("bshgd,bthd->bhgst", qg, k).to(torch.float32) \
        / _scale(dh, q)
    scores = _softcap(scores, cfg)
    if mask is not None:
        scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgst,bthd->bshgd", probs, v)
    return out.reshape(b, s, h, dh)


def _flash_sdpa(q, k, v, cfg: LMConfig, causal: bool,
                chunk: int = 512) -> torch.Tensor:
    """Memory-efficient attention: a loop over KV chunks with an online
    softmax (running max / normalizer), O(S * chunk) live memory."""
    b, s, h, dh = q.shape
    t, hk = k.shape[1], k.shape[2]
    g = h // hk
    if cfg.analysis_unroll:
        chunk = max(512, ((t // 16 + 127) // 128) * 128)
    qg = q.reshape(b, s, hk, g, dh) / _scale(dh, q).to(q.dtype)
    nc = -(-t // chunk)
    pad = nc * chunk - t
    kp = F.pad(k, (0, 0, 0, 0, 0, pad))
    vp = F.pad(v, (0, 0, 0, 0, 0, pad))
    q_idx = torch.arange(s, device=q.device)
    m = torch.full((b, hk, g, s), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hk, g, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hk, g, s, dh), dtype=torch.float32,
                      device=q.device)
    for i in range(nc):
        ks = kp[:, i * chunk:(i + 1) * chunk]
        vs = vp[:, i * chunk:(i + 1) * chunk]
        scores = torch.einsum("bshgd,bthd->bhgst", qg, ks).to(torch.float32)
        scores = _softcap(scores, cfg)
        k_idx = i * chunk + torch.arange(chunk, device=q.device)
        valid = k_idx[None, :] < t
        if causal:
            valid = valid & (k_idx[None, :] <= q_idx[:, None])
        scores = scores.masked_fill(~valid[None, None, None], -1e30)
        m_new = torch.maximum(m, torch.amax(scores, dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        l = alpha * l + torch.sum(p, dim=-1)
        acc = (acc * alpha[..., None]
               + torch.einsum("bhgst,bthd->bhgsd", p, vs.to(torch.float32)))
        m = m_new
    out = acc / torch.maximum(l, scalar(1e-30, l))[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, dh).to(q.dtype)


# Sequence length at/above which the flash path replaces materialized
# S x S scores for full attention.
FLASH_THRESHOLD = 2048


def _causal_mask(s: int, window: Optional[int], device) -> torch.Tensor:
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(s, device=device)[None, :]
    m = j <= i
    if window is not None:
        m &= (i - j) < window
    return m  # [S, S] -> broadcast over [B,Hk,G,S,T]


def attention(p, cfg: LMConfig, x: torch.Tensor, positions: torch.Tensor,
              policy: Policy = None, xkv: Optional[torch.Tensor] = None,
              causal: bool = True,
              path: Optional[str] = None) -> torch.Tensor:
    """Full-sequence attention (training / prefill).

    Sliding-window attention runs chunked (queries in chunks of W attend
    to their own and the previous key chunk, O(S*2W)); full attention at
    ``FLASH_THRESHOLD`` tokens and beyond takes the online-softmax loop.
    Cross-attention (``xkv`` given) is non-causal.
    """
    cross = xkv is not None
    xkv = x if xkv is None else xkv
    q, k, v = _qkv(p, cfg, x, xkv, policy, path)
    if not cross:
        q = _apply_rope(cfg, q, positions)
        k = _apply_rope(cfg, k, positions)
    w = cfg.sliding_window
    s = x.shape[1]
    if (not cross) and w is not None and s > 2 * w and s % w == 0:
        out = _swa_chunked(q, k, v, cfg, w)
    elif (not cross) and w is None and s >= FLASH_THRESHOLD:
        out = _flash_sdpa(q, k, v, cfg, causal)
    else:
        mask = None
        if causal and not cross:
            mask = _causal_mask(s, w, x.device)[None, None, None]
        out = _sdpa(q, k, v, cfg, mask)
    b = x.shape[0]
    return linear(p["wo"], out.reshape(b, s, -1), policy,
                  join_path(path, "wo"))


def _swa_chunked(q, k, v, cfg: LMConfig, w: int) -> torch.Tensor:
    """Sliding-window attention in O(S * 2W): chunk queries by window size;
    each chunk attends to its own and the previous key/value chunk."""
    b, s, h, dh = q.shape
    hk = k.shape[2]
    nc = s // w
    qc = q.reshape(b, nc, w, h, dh)
    kc = k.reshape(b, nc, w, hk, dh)
    vc = v.reshape(b, nc, w, hk, dh)
    # previous chunk (zero-padded at the front; masked out anyway)
    kp = torch.cat([torch.zeros_like(kc[:, :1]), kc[:, :-1]], dim=1)
    vp = torch.cat([torch.zeros_like(vc[:, :1]), vc[:, :-1]], dim=1)
    k2 = torch.cat([kp, kc], dim=2)      # [B,nc,2W,Hk,Dh]
    v2 = torch.cat([vp, vc], dim=2)
    g = h // hk
    qg = qc.reshape(b, nc, w, hk, g, dh)
    scores = torch.einsum("bcshgd,bcthd->bchgst", qg, k2).to(torch.float32) \
        / _scale(dh, q)
    dev = q.device
    i = torch.arange(w, device=dev)[:, None]        # query offset in chunk
    j = torch.arange(2 * w, device=dev)[None, :]    # key offset [prev, own]
    rel = (i + w) - j
    mask = (rel >= 0) & (rel < w)
    first = torch.arange(nc, device=dev) == 0       # first chunk: no prev
    mask_all = mask[None] & ~(first[:, None, None] & (j < w)[None])
    scores = scores.masked_fill(~mask_all[None, :, None, None], -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bchgst,bcthd->bcshgd", probs, v2)
    return out.reshape(b, s, h, dh)


def attention_decode(p, cfg: LMConfig, x: torch.Tensor, pos: int,
                     kcache: torch.Tensor, vcache: torch.Tensor,
                     policy: Policy = None, path: Optional[str] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token decode with KV cache.

    x: [B, 1, D]; kcache/vcache: [B, T, Hk, Dh] (T = max_len, or the
    window size when sliding-window — a ring buffer indexed pos % T);
    ``pos`` the position of every row.  Returns (out [B,1,D], new kcache,
    new vcache).  The caches are updated out of place: the serve engine
    keeps the old ones to restore the rows of other slots."""
    b = x.shape[0]
    t = kcache.shape[1]
    pos = int(pos)
    q = linear(p["wq"], x, policy,
               join_path(path, "wq")).reshape(b, 1, cfg.n_heads, cfg.dh)
    k = linear(p["wk"], x, policy,
               join_path(path, "wk")).reshape(b, 1, cfg.n_kv_heads, cfg.dh)
    v = linear(p["wv"], x, policy,
               join_path(path, "wv")).reshape(b, 1, cfg.n_kv_heads, cfg.dh)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q = _apply_rope(cfg, q, positions)
    k = _apply_rope(cfg, k, positions)

    slot = pos % t                       # ring buffer for SWA; == pos otherwise
    kcache, vcache = kcache.clone(), vcache.clone()
    kcache[:, slot:slot + 1] = k.to(kcache.dtype)
    vcache[:, slot:slot + 1] = v.to(vcache.dtype)
    # valid positions: those already written (<= pos), within window if SWA
    written = t if pos >= t else pos + 1
    mask = (torch.arange(t, device=x.device) < written)[None, None, None,
                                                        None, :]
    out = _sdpa(q, kcache.to(q.dtype), vcache.to(q.dtype), cfg, mask)
    return (linear(p["wo"], out.reshape(b, 1, -1), policy,
                   join_path(path, "wo")), kcache, vcache)


# ---------------------------------------------------------------------------
# SwiGLU FFN
# ---------------------------------------------------------------------------

def swiglu_init(gen: torch.Generator, d: int, f: int, *, lead: Shape = (),
                device: torch.device):
    kw = dict(lead=lead, device=device)
    return {"w1": linear_init(gen, d, f, **kw),    # gate
            "w3": linear_init(gen, d, f, **kw),    # up
            "w2": linear_init(gen, f, d, **kw)}    # down


def swiglu(p, x: torch.Tensor, policy: Policy = None,
           path: Optional[str] = None) -> torch.Tensor:
    h = F.silu(linear(p["w1"], x, policy, join_path(path, "w1"))) \
        * linear(p["w3"], x, policy, join_path(path, "w3"))
    return linear(p["w2"], h, policy, join_path(path, "w2"))
