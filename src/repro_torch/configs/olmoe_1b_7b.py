"""olmoe-1b-7b [moe] — 64 experts top-8.  [arXiv:2409.02060; hf]

16L d_model=2048 16H (MHA kv=16) d_ff=1024 vocab=50304.
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    head_dim=128,
    n_experts=64,
    top_k=8,
    max_seq_len=4096,
)
