"""``chip_smoke.lm_train_launches`` — the launches one training step
makes on the card, read from the model code — against the GEMMs a step
taps on the CPU, for the families the card trains at width: RWKV6, the
hybrid (one (rec, rec, attn) period) and the encoder-decoder (at an odd
vocabulary, so its head takes the tile kernel and its #dx a block that
is no power of two), plus the dense and MoE stacks.

All at ``PALLAS_TILED`` block 32 (``reduced()`` widths are 64-256), as
phase 16's ``train_families_smoke`` runs them.  On the CPU the kernel
backend runs the kernels' plain versions, so the
counters do not move; each tapped GEMM (forward, #dx, #dw) is given the
core ``kernels.bfp_matmul.matmul_core`` picks for its shapes and its
policy, as the card's wrapper does.
"""
import os
import sys

import pytest
import torch

from repro_torch import engine as EG
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import ARCHS
from repro_torch.core.policy import PALLAS_TILED
from repro_torch.data.pipeline import LMBatchSpec, lm_batch
from repro_torch.kernels.bfp_matmul import matmul_core
from repro_torch.train import step as TS

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as CS  # noqa: E402

#: (arch, layers, vocabulary) at ``reduced()`` widths
CASES = [("rwkv6-3b", 2, 256), ("recurrentgemma-9b", 3, 256),
         ("seamless-m4t-medium", 2, 250), ("tinyllama-1.1b", 2, 256),
         ("olmoe-1b-7b", 2, 256)]
B, S = 2, 32


def _tapped_launches(cfg, pol):
    state = TS.init_state(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    batch = lm_batch(LMBatchSpec(vocab_size=cfg.vocab_size, seq_len=S,
                                 global_batch=B, seed=0), 0, device="cpu")
    events = []
    with EG.taps(events.append):
        TS.make_train_step(cfg, policy=pol)(state, batch)
    out = {"bfp_matmul": 0, "bfp_matmul_pformat": 0}
    for ev in events:
        if ev.policy is None or ev.backend == "float":
            continue
        k, n = ev.w.shape[-2:]
        out["bfp_matmul"] += 1
        if matmul_core(False, ev.policy.block_k or k, k, n, ev.policy.l_i,
                       ev.policy.l_w) == "mma":
            out["bfp_matmul_pformat"] += 1
    return {k: v for k, v in out.items() if v}


@pytest.mark.parametrize("arch,layers,vocab", CASES)
def test_train_launches_equal_the_tapped_step(arch, layers, vocab):
    cfg = reduced(ARCHS[arch], n_layers=layers, vocab=vocab)
    for st in (True, False):
        pol = PALLAS_TILED.with_(block_k=32, straight_through=st)
        want = CS.lm_train_launches(cfg, st, B, S, pol)
        assert _tapped_launches(cfg, pol) == want, (arch, st)
    tile = want["bfp_matmul"] - want["bfp_matmul_pformat"]
    if vocab % 4:
        assert tile >= 3            # the head's forward, #dx and #dw
    if cfg.family == "hybrid":      # MQA's wk / wv #dx contract N = 16
        assert tile == 2
