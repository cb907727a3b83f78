"""rwkv6-3b [ssm] — Finch: attention-free, data-dependent decay.
[arXiv:2404.05892; hf]

32L d_model=2560 d_ff=8960 vocab=65536; head_size 64 -> 40 WKV heads.
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,          # WKV heads (head_size 64)
    n_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    head_dim=64,
    max_seq_len=1 << 20,  # constant-state recurrence
)
