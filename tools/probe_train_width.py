"""What sizes the width training paths of ``chip_smoke.py`` phase 16: the
peak memory of one ``make_train_step`` step at a depth, and seamless'
head #dx GEMM alone.

    python3 tools/probe_train_width.py memory ARCH LAYERS [LAYERS ...]
    python3 tools/probe_train_width.py head

``memory``: ARCH at published width cut to each LAYERS, seeded on the
card, one step at ``PALLAS_TILED`` without straight-through, B = 4,
S = 256: the step's seconds and ``max_memory_allocated`` (or the
out-of-memory error and the peak reached).  ``head``: the #dx GEMM of
seamless-m4t-medium's head, g [M, 256,206] @ w.T [256,206, 1,024] at
the block ``fit_grad_policy`` fits to 256,206 (6: 42,701 K-tiles, the
tile kernel), at M = 64, 256 and 1,024: its ms (CUDA events, 2 calls)
and, at M = 1,024, its plain version's seconds and ``torch.equal``.
Each line carries the card's name and power limit.  Needs a CUDA card
and nvcc.
"""
import dataclasses
import gc
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from repro_torch import engine as EG  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.core.policy import PALLAS_TILED  # noqa: E402
from repro_torch.grad.paths import fit_grad_policy  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

POL = PALLAS_TILED.with_(straight_through=False)


def memory(card, arch, layers):
    from repro_torch.data.pipeline import LMBatchSpec, lm_batch
    from repro_torch.train import step as TS

    cfg = dataclasses.replace(ARCHS[arch], n_layers=layers)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        state = TS.init_state(cfg, torch.Generator(device="cuda")
                              .manual_seed(0), device="cuda")
        batch = lm_batch(LMBatchSpec(vocab_size=cfg.vocab_size, seq_len=256,
                                     global_batch=4, seed=0), 0,
                         device="cuda")
        step = TS.make_train_step(cfg, policy=POL)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, m = step(state, batch)
        torch.cuda.synchronize()
        print(f"memory {arch} {layers} layers: step "
              f"{time.perf_counter() - t0:.2f} s, loss {float(m['loss']):.4f},"
              f" peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB  "
              f"[{card}]", flush=True)
        del new, m, state
    except torch.cuda.OutOfMemoryError as e:
        print(f"memory {arch} {layers} layers: out of memory at peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB ({e})  "
              f"[{card}]".splitlines()[0], flush=True)


def head(card):
    CS.register_plain_backend()
    n, k = ARCHS["seamless-m4t-medium"].vocab_size, 1024
    pol = fit_grad_policy(POL, n)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for m in (64, 256, 1024):
        g = torch.randn(m, n, generator=gen, device="cuda")
        w = torch.randn(n, k, generator=gen, device="cuda")
        ms = CS.cuda_ms(lambda: EG.gemm(g, w, pol), reps=2, warmup=1)
        line = (f"head seamless #dx M = {m}, K = {n} at block "
                f"{pol.block_k}: {ms:.2f} ms")
        if m == 1024:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plain = EG.gemm(g, w, pol.with_(backend="plain"))
            torch.cuda.synchronize()
            line += (f"; plain version {time.perf_counter() - t0:.2f} s, "
                     f"torch.equal {torch.equal(EG.gemm(g, w, pol), plain)}")
        print(f"{line}  [{card}]", flush=True)
        del g, w


if __name__ == "__main__":
    torch.backends.cuda.matmul.allow_tf32 = False
    card = CS.card_line()
    _build.build()
    if sys.argv[1] == "memory":
        for layers in sys.argv[3:]:
            memory(card, sys.argv[2], int(layers))
    else:
        head(card)
