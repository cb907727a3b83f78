"""minicpm-2b [dense] — llama-like arch trained with the WSD schedule
(the schedule is implemented in repro.optim).  [arXiv:2404.06395; hf]

40L d_model=2304 36H (MHA kv=36) d_ff=5760 vocab=122753.
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab_size=122753,
    head_dim=64,
    max_seq_len=4096,
    tie_embeddings=True,
)
