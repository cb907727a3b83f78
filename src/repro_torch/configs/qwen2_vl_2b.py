"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution.  [arXiv:2409.12191; hf]

Backbone only (per assignment the vision frontend is a stub; input_specs
provides precomputed patch embeddings).  28L d_model=1536 12H (GQA kv=2)
d_ff=8960 vocab=151936.  M-RoPE sections (16, 24, 24) over the 64
rotary-half dims of head_dim=128.
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    head_dim=128,
    qkv_bias=True,
    mrope_sections=(16, 24, 24),
    max_seq_len=32768,
)
