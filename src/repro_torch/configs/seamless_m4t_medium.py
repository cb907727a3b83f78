"""seamless-m4t-medium [audio] — encoder-decoder, multimodal.
[arXiv:2308.11596; hf]

Transformer backbone only: 12L encoder + 12L decoder, d_model=1024 16H
(MHA kv=16) d_ff=4096 vocab=256206.  The speech frontend is a stub —
input_specs() provides precomputed frame embeddings [B, S_enc, d_model].
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,           # decoder layers
    encoder_layers=12,
    enc_seq_stub=1024,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    head_dim=64,
    max_seq_len=4096,
)
