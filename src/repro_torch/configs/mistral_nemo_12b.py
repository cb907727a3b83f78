"""mistral-nemo-12b [dense] — 128k-context GQA transformer.
[hf:mistralai/Mistral-Nemo-Base-2407; hf]

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072, head_dim=128.
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=131072,
    head_dim=128,
    rope_theta=1_000_000.0,
    max_seq_len=131072,
)
