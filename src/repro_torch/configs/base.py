"""Architecture config schema + input-shape definitions of the LM
families (counterpart of ``repro.configs.base``, kept as the port's own
copy: pure Python, architecture shapes only, no weights)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["LMConfig", "ShapeConfig", "SHAPES", "reduced"]


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """One LM-family architecture.  All sizes are the exact public configs
    (see ``repro_torch/configs/<id>.py`` for sources)."""

    name: str
    family: str                      # dense | hybrid | ssm | vlm | moe | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // n_heads

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # --- attention variants --------------------------------------------------
    sliding_window: Optional[int] = None   # SWA (mixtral) / local attn window
    qkv_bias: bool = False                 # qwen QKV bias
    rope_theta: float = 10000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl M-RoPE

    # --- hybrid / ssm ---------------------------------------------------------
    block_pattern: Optional[Tuple[str, ...]] = None  # e.g. ("rec","rec","attn")
    lru_width: Optional[int] = None                  # RG-LRU state width
    conv_width: int = 4                              # temporal conv (griffin)

    # --- encoder-decoder -----------------------------------------------------
    encoder_layers: int = 0          # >0 => enc-dec (seamless)
    enc_seq_stub: int = 1024         # precomputed frame/patch embeddings length

    # --- misc ------------------------------------------------------------------
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    compute_dtype: str = "float32"   # activations dtype (dry-run: bfloat16)
    analysis_unroll: bool = False    # unroll layer/chunk loops so XLA
                                     # cost_analysis counts every trip
                                     # (scan bodies are visited once)
    max_seq_len: int = 131072
    attn_logit_softcap: Optional[float] = None

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (DESIGN.md §4 shape applicability)."""
        if self.family == "ssm":
            return True
        if self.block_pattern is not None:   # hybrid: local attn + recurrent
            return True
        return self.sliding_window is not None

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model-FLOPs roofline)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        dh, h, hk = self.dh, self.n_heads, self.n_kv_heads
        attn = d * (h * dh) + 2 * d * (hk * dh) + (h * dh) * d

        def ffn_params():
            return 3 * d * f  # SwiGLU (gate, up, down)

        per_layer = 0
        n_dec = self.n_layers
        if self.block_pattern:
            pat = self.block_pattern
            reps = -(-self.n_layers // len(pat))
            kinds = (pat * reps)[: self.n_layers]
            total = 0
            lw = self.lru_width or d
            for kind in kinds:
                if kind == "attn":
                    total += attn + ffn_params() + 2 * d
                else:  # recurrent block
                    rec = 2 * d * lw + lw * self.conv_width + 2 * lw + lw * d
                    total += rec + ffn_params() + 2 * d
            body = total
        elif self.family == "ssm":  # rwkv6
            per_layer = 4 * d * d + d * d  # r,k,v,g,o projections (square)
            per_layer += 2 * d * self.d_ff  # channel-mix (k, v)
            body = self.n_layers * per_layer
        elif self.is_moe:
            per_layer = attn + self.n_experts * ffn_params() + d * self.n_experts + 2 * d
            body = self.n_layers * per_layer
        else:
            per_layer = attn + ffn_params() + 2 * d
            body = self.n_layers * per_layer
        if self.is_encdec:
            enc_layer = attn + ffn_params() + 2 * d
            cross = attn
            body = (self.encoder_layers * enc_layer
                    + self.n_layers * (attn + cross + ffn_params() + 3 * d))
        emb = v * d * (1 if self.tie_embeddings else 2)
        return body + emb

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if not self.is_moe:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense_like = self.param_count() - self.n_layers * (self.n_experts - self.top_k) * 3 * d * f
        return dense_like


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def reduced(cfg: LMConfig, n_layers: int = 2, d_model: int = 64,
            d_ff: int = 128, vocab: int = 256, lru_width: Optional[int] = None
            ) -> LMConfig:
    """Reduced same-family config for CPU smoke tests."""
    heads = max(2, min(4, cfg.n_heads))
    kv = 1 if cfg.n_kv_heads == 1 else max(1, heads // 2) \
        if cfg.n_kv_heads < cfg.n_heads else heads
    kw = dict(
        name=cfg.name + "-smoke", n_layers=n_layers, d_model=d_model,
        n_heads=heads, n_kv_heads=kv, d_ff=d_ff, vocab_size=vocab,
        head_dim=d_model // heads,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else None,
        max_seq_len=512,
    )
    if cfg.is_moe:
        kw.update(n_experts=min(cfg.n_experts, 4), top_k=min(cfg.top_k, 2))
    if cfg.block_pattern:
        kw.update(block_pattern=cfg.block_pattern,
                  lru_width=lru_width or d_model, conv_width=cfg.conv_width)
    if cfg.is_encdec:
        kw.update(encoder_layers=max(1, n_layers // 2), enc_seq_stub=32)
    if cfg.mrope_sections:
        s = (d_model // heads) // 2
        a = s // 3
        kw.update(mrope_sections=(s - 2 * a, a, a))
    return dataclasses.replace(cfg, **kw)
