"""RWKV-6 "Finch" of the port (counterpart of ``repro.models.lm.rwkv6``):
attention-free time mixing with data-dependent per-channel decay.

Recurrence per head (Dk = Dv = head_dim):

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

The full sequence (forward, prefill) runs the reference's CHUNKED form:
a Python loop over chunks of 32 carrying S, quadratic within a chunk,
all in f32, with the reference's clamps (``max(w, 1e-38)`` before the
log, the log-decay clipped at ``_LOGW_MIN`` = -2).  Decode is the
single-step recurrence, its decay clamped at ``e^-2``.  The WKV
recurrence is elementwise and outer products (no GEMM), so BFP applies to
the projections only (r, k, v, g, the decay LoRA, the output and the
channel mix).

As in the reference, the decode forms drop the policy: ``time_mix_decode``
and ``channel_mix_decode`` run every projection with ``policy=None`` (the
float backend, over dequantized prequant weights), and no linear here
passes a ``path``, so under a bound plan the forward's GEMMs resolve the
policy per call.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch import engine as EG
from repro_torch.configs.base import LMConfig
from repro_torch.dist.sharding import shard
from repro_torch.models.lm.common import (Shape, linear, linear_init, normal,
                                          rmsnorm, rmsnorm_init, scalar)

__all__ = ["time_mix_init", "time_mix", "time_mix_decode",
           "channel_mix_init", "channel_mix", "channel_mix_decode"]

Policy = EG.PolicyLike

_CHUNK = 32
_LORA = 64  # decay LoRA rank (Finch uses 64 for ~3b)
# Per-step log-decay clamp: keeps every exponential of the chunked form
# inside the f32 range (chunk 32 x 2.0 = 64 < log(3.4e38) ~ 88).
_LOGW_MIN = -2.0


def _uniform(gen: torch.Generator, shape: Shape, device) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device).to(device)


def time_mix_init(gen: torch.Generator, cfg: LMConfig, *, lead: Shape = (),
                  device: torch.device):
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.dh
    kw = dict(lead=lead, device=device)
    return {
        "mu": _uniform(gen, (*lead, 5, d), device),  # shift mix r,k,v,w,g
        "wr": linear_init(gen, d, d, **kw),
        "wk": linear_init(gen, d, d, **kw),
        "wv": linear_init(gen, d, d, **kw),
        "wg": linear_init(gen, d, d, **kw),
        "wo": linear_init(gen, d, d, **kw),
        # data-dependent decay LoRA: w_t = exp(-exp(w0 + tanh(x@A)@B))
        "w0": torch.full((*lead, d), -0.5, device=device),
        "wA": linear_init(gen, d, _LORA, **kw),
        "wB": linear_init(gen, _LORA, d, **kw),
        "u": normal(gen, (*lead, h, dh), 0.1, device),   # bonus
        "ln": rmsnorm_init(d, **kw),
    }


def _token_shift(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """The shifted sequence [x_prev, x_0 .. x_{S-2}] (one-step delay)."""
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1)


def _projections(p, cfg: LMConfig, x, x_prev, policy: Policy):
    b, s, _ = x.shape
    xs = _token_shift(x, x_prev.to(x.dtype))
    mu = p["mu"].to(x.dtype)

    def mix(i):
        return x + mu[i] * (xs - x)

    r = linear(p["wr"], mix(0), policy)
    k = linear(p["wk"], mix(1), policy)
    v = linear(p["wv"], mix(2), policy)
    xw = mix(3)
    g = linear(p["wg"], mix(4), policy)
    # data-dependent decay (the Finch feature): low-rank modulation
    logw = p["w0"] + linear(p["wB"], torch.tanh(linear(p["wA"], xw,
                                                       policy)), policy)
    w = torch.exp(-torch.exp(logw.to(torch.float32)))      # in (0, 1)
    shp = (b, s, cfg.n_heads, cfg.dh)
    return (r.reshape(shp), k.reshape(shp), v.reshape(shp), w.reshape(shp),
            g * torch.sigmoid(g))                          # jax.nn.silu


def _wkv_chunked(r, k, v, w, u) -> torch.Tensor:
    """Chunked WKV.  r, k, v, w: [B, S, H, D]; u: [H, D] -> [B, S, H, D].

    Within a chunk (length C, f32):
      P_i  = prod_{j<=i} w_j          (inclusive cumulative decay)
      r~_i = r_i * P_{i-1},  k~_j = k_j / P_j
      o_i  = r~_i @ S_0 + sum_{j<i} (r~_i . k~_j) v_j + ((r_i*u) . k_i) v_i
      S_C  = diag(P_C) S_0 + sum_j diag(P_C / P_j) k_j^T v_j
    """
    b, s, h, d = r.shape
    c = min(_CHUNK, s)
    if s % c:
        raise ValueError(f"seq {s} must be a multiple of chunk {c}")
    n = s // c
    f32 = torch.float32
    rc, kc, vc, wc = (t.to(f32).reshape(b, n, c, h, d).permute(1, 0, 3, 2, 4)
                      for t in (r, k, v, w))            # [n, B, H, C, D]

    # maximum / minimum against tensors, not clamp: at a tie their
    # gradient splits 0.5 / 0.5, as jnp.maximum's and jnp.clip's do
    logw = torch.minimum(torch.maximum(torch.log(torch.maximum(
        wc, scalar(1e-38, wc))), scalar(_LOGW_MIN, wc)), scalar(0.0, wc))
    logp = torch.cumsum(logw, dim=3)                     # inclusive
    pprev = torch.exp(logp - logw)                       # exclusive (P_{i-1})
    r_t = rc * pprev
    k_t = kc * torch.exp(-logp)                          # k_j / P_j
    pend = torch.exp(logp[:, :, :, -1:, :])              # P_C [n,B,H,1,D]

    # intra-chunk attention: A[i, j] = (r~_i . k~_j) for j < i; diag uses u
    mask = torch.tril(torch.ones((c, c), dtype=f32, device=r.device),
                      diagonal=-1)
    a = torch.einsum("nbhid,nbhjd->nbhij", r_t, k_t) * mask
    diag = torch.einsum("nbhid,nbhid->nbhi",
                        rc * u.to(f32)[None, None, :, None, :], kc)
    intra = torch.einsum("nbhij,nbhjd->nbhid", a, vc) + diag[..., None] * vc

    # each chunk's state contribution: sum_j (P_C / P_j * k_j)^T v_j
    kdec = kc * (pend * torch.exp(-logp))
    chunk_state = torch.einsum("nbhjd,nbhje->nbhde", kdec, vc)

    state = torch.zeros((b, h, d, d), dtype=f32, device=r.device)
    inter = []
    for i in range(n):
        inter.append(torch.einsum("bhid,bhde->bhie", r_t[i], state))
        state = state * pend[i].transpose(2, 3) + chunk_state[i]  # decay Dk
    out = (intra + torch.stack(inter)).permute(1, 0, 3, 2, 4).reshape(
        b, s, h, d)
    return out.to(r.dtype)


def time_mix(p, cfg: LMConfig, x: torch.Tensor, x_prev: torch.Tensor,
             policy: Policy = None) -> torch.Tensor:
    """Full-sequence WKV (forward / prefill).  x_prev: [B, D] delay-line
    state."""
    r, k, v, w, g = _projections(p, cfg, x, x_prev, policy)
    o = _wkv_chunked(r, k, v, w, p["u"])
    b, s = x.shape[0], x.shape[1]
    o = rmsnorm(p["ln"], o.reshape(b, s, -1), cfg.norm_eps)
    return linear(p["wo"], o * g, policy)


def time_mix_decode(p, cfg: LMConfig, x: torch.Tensor, state
                    ) -> Tuple[torch.Tensor, Tuple]:
    """One-token step.  x: [B, 1, D]; state = (x_prev [B, D], S [B, H, D,
    D]).  Every projection runs with ``policy=None``, as the
    reference's."""
    x_prev, s_prev = state
    r, k, v, w, g = _projections(p, cfg, x, x_prev, None)
    f32 = torch.float32
    r1, k1, v1, w1 = (t[:, 0].to(f32) for t in (r, k, v, w))   # [B, H, D]
    u = p["u"].to(f32)
    kv = torch.einsum("bhd,bhe->bhde", k1, v1)
    o = torch.einsum("bhd,bhde->bhe", r1, s_prev + u[None, :, :, None] * kv)
    w1 = torch.maximum(w1, scalar(math.exp(_LOGW_MIN), w1))  # forward's clamp
    s_new = s_prev * w1[..., None] + kv
    b = x.shape[0]
    o = rmsnorm(p["ln"], o.reshape(b, 1, -1).to(x.dtype), cfg.norm_eps)
    out = linear(p["wo"], o * g, None)
    return out, (x[:, -1], s_new)


# ---------------------------------------------------------------------------
# Channel mix (RWKV FFN)
# ---------------------------------------------------------------------------

def channel_mix_init(gen: torch.Generator, cfg: LMConfig, *,
                     lead: Shape = (), device: torch.device):
    d, f = cfg.d_model, cfg.d_ff
    kw = dict(lead=lead, device=device)
    return {"mu": _uniform(gen, (*lead, 2, d), device),
            "wk": linear_init(gen, d, f, **kw),
            "wv": linear_init(gen, f, d, **kw),
            "wr": linear_init(gen, d, d, **kw)}


def channel_mix(p, cfg: LMConfig, x: torch.Tensor, x_prev: torch.Tensor,
                policy: Policy = None) -> torch.Tensor:
    xs = _token_shift(x, x_prev.to(x.dtype))
    mu = p["mu"].to(x.dtype)
    xk = x + mu[0] * (xs - x)
    xr = x + mu[1] * (xs - x)
    k = torch.square(torch.relu(linear(p["wk"], xk, policy)))
    k = shard(k, "batch", "seq", "ffn")
    return torch.sigmoid(linear(p["wr"], xr, policy)) * \
        linear(p["wv"], k, policy)


def channel_mix_decode(p, cfg: LMConfig, x: torch.Tensor,
                       x_prev: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token channel mix with ``policy=None``, as the reference's."""
    out = channel_mix(p, cfg, x, x_prev, None)
    return out, x[:, -1]
