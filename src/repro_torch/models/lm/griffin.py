"""RG-LRU recurrent block of the port (Griffin / recurrentgemma,
counterpart of ``repro.models.lm.griffin``).

Block: x -> [linear -> causal depthwise conv1d(4) -> RG-LRU] * [linear ->
GeLU] -> linear.  RG-LRU per channel:

    r_t = sigmoid(x_t @ Wr)              (recurrence gate)
    i_t = sigmoid(x_t @ Wi)              (input gate)
    a_t = exp(-c * softplus(L) * r_t)    (data-dependent decay, c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The full sequence runs the recurrence as the reference's
``jax.lax.associative_scan`` does: the same odd/even recursion over the
sequence (pairs combined, the half-length scan recursed, the even
elements filled in), with each ``a2 * b1 + b2`` one fused multiply-add as
XLA:CPU contracts it (``addcmul``), so every element of the scan is the
same chain of roundings as the reference's.
The recurrence is elementwise (no GEMM), so BFP applies to the
surrounding projections only.  No linear here passes a ``path``: under a
bound plan they resolve the policy per call, as in the reference.

``jax.nn`` semantics kept where PyTorch's defaults differ: GeLU is the
tanh approximation, softplus is ``logaddexp(x, 0)`` (no threshold).
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

import torch

from repro_torch import engine as EG
from repro_torch.configs.base import LMConfig
from repro_torch.models.lm.common import (Shape, linear, linear_init, normal,
                                          scalar)

__all__ = ["rglru_block_init", "rglru_block", "rglru_block_decode"]

Policy = EG.PolicyLike
_C = 8.0


def rglru_block_init(gen: torch.Generator, cfg: LMConfig, *,
                     lead: Shape = (), device: torch.device):
    d = cfg.d_model
    lw = cfg.lru_width or d
    kw = dict(lead=lead, device=device)
    # Lambda so the decay a is in (0.9, 0.999) at r = 1 (Griffin appendix)
    lam = 0.9 + 0.099 * torch.rand((*lead, lw), generator=gen,
                                   device=gen.device)
    softplus_inv = torch.log(torch.expm1(-torch.log(lam) / _C))
    return {
        "in_x": linear_init(gen, d, lw, **kw),
        "in_g": linear_init(gen, d, lw, **kw),
        "conv_w": normal(gen, (*lead, cfg.conv_width, lw), 0.1, device),
        "conv_b": torch.zeros((*lead, lw), device=device),
        "wr": linear_init(gen, lw, lw, **kw),
        "wi": linear_init(gen, lw, lw, **kw),
        "lam": softplus_inv.to(device),
        "out": linear_init(gen, lw, d, **kw),
    }


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (``approximate=True``), written as the reference
    computes it."""
    c = math.sqrt(2 / math.pi)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x * x * x))))
    return x * cdf


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` = max(x, 0) +
    log1p(exp(-|x|)), with no linear threshold; its gradient at 0 is
    0.5, as ``logaddexp``'s."""
    return (torch.maximum(x, scalar(0.0, x))
            + torch.log1p(torch.exp(-torch.abs(x))))


def _causal_conv(w, b, x, x_hist=None):
    """Causal depthwise conv1d.  x: [B, S, C]; w: [W, C]; x_hist: [B, W-1,
    C] of previous inputs for decode continuity (None: zeros)."""
    width = w.shape[0]
    w = w.to(x.dtype)
    if x_hist is None:
        x_hist = torch.zeros((x.shape[0], width - 1, x.shape[2]),
                             dtype=x.dtype, device=x.device)
    xp = torch.cat([x_hist.to(x.dtype), x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(width))
    return out + b.to(x.dtype)


Elems = List[torch.Tensor]


def associative_scan(fn: Callable[[Elems, Elems], Elems], elems: Elems,
                     dim: int) -> Elems:
    """Inclusive scan of ``fn`` along ``dim`` by ``jax.lax
    .associative_scan``'s recursion: combine adjacent pairs, scan that
    half-length sequence (the odd elements), combine each odd result with
    the next even input (the even elements), and interleave."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems

    def sl(t, start, stop=None, step=1):
        idx = [slice(None)] * t.ndim
        idx[dim] = slice(start, stop, step)
        return t[tuple(idx)]

    odd = associative_scan(fn, fn([sl(e, 0, -1, 2) for e in elems],
                                  [sl(e, 1, None, 2) for e in elems]), dim)
    if n % 2 == 0:
        even = fn([sl(e, 0, -1) for e in odd],
                  [sl(e, 2, None, 2) for e in elems])
    else:
        even = fn(odd, [sl(e, 2, None, 2) for e in elems])
    even = [torch.cat([sl(e, 0, 1), r], dim=dim)
            for e, r in zip(elems, even)]
    out = []
    for ev, od in zip(even, odd):          # interleave: ev0 od0 ev1 od1 ..
        t = torch.empty((*ev.shape[:dim], n, *ev.shape[dim + 1:]),
                        dtype=ev.dtype, device=ev.device)
        sl(t, 0, None, 2).copy_(ev)
        sl(t, 1, None, 2).copy_(od)
        out.append(t)
    return out


def _combine(c1: Elems, c2: Elems) -> Elems:
    """(a1, b1) then (a2, b2): (a1 a2, a2 b1 + b2), the second a fused
    multiply-add (``addcmul``), as XLA contracts it."""
    a1, b1 = c1
    a2, b2 = c2
    return [a1 * a2, torch.addcmul(b2, a2, b1)]


def _gates(p, x, policy):
    """(decay a, gated input) of the RG-LRU over x [B, S, C]."""
    f32 = torch.float32
    r = torch.sigmoid(linear(p["wr"], x, policy).to(f32))
    i = torch.sigmoid(linear(p["wi"], x, policy).to(f32))
    log_a = -_C * softplus(p["lam"]) * r
    one_m = 1.0 - torch.exp(2.0 * log_a)
    drive = torch.sqrt(torch.maximum(one_m, scalar(1e-12, one_m))) * (
        i * x.to(f32))
    return torch.exp(log_a), drive


def _rglru(p, x: torch.Tensor, h0: Optional[torch.Tensor], policy: Policy
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, C] -> (y [B, S, C], h_last [B, C]) by the associative
    scan."""
    a, gated = _gates(p, x, policy)
    if h0 is not None:
        gated = gated.clone()
        gated[:, 0] = torch.addcmul(gated[:, 0], a[:, 0],
                                    h0.to(torch.float32))
    _, h = associative_scan(_combine, [a, gated], dim=1)
    return h.to(x.dtype), h[:, -1]


def rglru_block(p, cfg: LMConfig, x: torch.Tensor, state=None,
                policy: Policy = None):
    """Full-sequence Griffin recurrent block.  ``state``: None (forward)
    or (h0 [B, C], conv_hist [B, W-1, C]) to continue a chunked prefill.
    Returns (y, new_state)."""
    h0, hist = state if state is not None else (None, None)
    gate = gelu(linear(p["in_g"], x, policy))
    u = linear(p["in_x"], x, policy)
    u_conv = _causal_conv(p["conv_w"], p["conv_b"], u, hist)
    h, h_last = _rglru(p, u_conv, h0, policy)
    y = linear(p["out"], h * gate, policy)
    width = p["conv_w"].shape[0]
    new_hist = u[:, -(width - 1):] if u.shape[1] >= width - 1 else u
    return y, (h_last, new_hist)


def rglru_block_decode(p, cfg: LMConfig, x: torch.Tensor, state,
                       policy: Policy = None):
    """Single-token step.  x: [B, 1, D]; state = (h [B, C], conv_hist
    [B, W-1, C]).  The new history is the old one's tail and this step's
    input, promoted as ``jnp.concatenate`` promotes: a bf16 history meets
    the f32 input and comes back f32."""
    h_prev, hist = state
    gate = gelu(linear(p["in_g"], x, policy))
    u = linear(p["in_x"], x, policy)                          # [B, 1, C]
    u_conv = _causal_conv(p["conv_w"], p["conv_b"], u, hist)
    a, drive = _gates(p, u_conv, policy)
    h = torch.addcmul(drive[:, 0], a[:, 0], h_prev.to(torch.float32))
    y = linear(p["out"], h[:, None].to(x.dtype) * gate, policy)
    dt = torch.promote_types(hist.dtype, u.dtype)
    new_hist = torch.cat([hist[:, 1:].to(dt), u.to(dt)], dim=1)
    return y, (h, new_hist)
