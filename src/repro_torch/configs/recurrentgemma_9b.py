"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 2:1 recurrent:attn
pattern.  [arXiv:2402.19427; unverified]

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000, local window 2048.
38 = 12 x (rec, rec, attn) + 2 trailing recurrent blocks.
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    sliding_window=2048,
    block_pattern=("rec", "rec", "attn"),
    lru_width=4096,
    conv_width=4,
    rope_theta=10000.0,
    max_seq_len=524288,   # unbounded in principle (constant-state recurrence)
    tie_embeddings=True,
)
