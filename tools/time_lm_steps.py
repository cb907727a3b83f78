"""Time TinyLlama-1.1B's decode step and training step, for A/B runs.

    python3 tools/time_lm_steps.py CHECKOUT LABEL

Imports ``repro_torch`` from ``CHECKOUT/src`` (this tree, or a ``git
archive`` of another commit unpacked elsewhere), builds its kernels and
times, at published width with seeded random weights, the two steps
``chip_smoke.py`` times: the decode step of phase 14 (``ServeEngine`` at
``PALLAS_TILED``, strict, weights prequantized, 4 slots, 256 positions,
M = 4; the median of 20 by CUDA events after 4 steps and a warm-up) and
the training step of phase 16 (B = 8, S = 256, ``PALLAS_TILED`` without
the straight-through estimator, AdamW on a cosine schedule; the median
of 5 after 2 steps).  Prints one line ``AB {...}`` with both medians,
every time and the card's name and power limit.  Run two checkouts in
turns in one call (A, B, B, A) to compare them; needs a CUDA card and
nvcc.
"""
import json
import os
import statistics
import subprocess
import sys
import time

root = os.path.abspath(sys.argv[1])
sys.path.insert(0, os.path.join(root, "src"))
import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402

assert _build.__file__.startswith(root), _build.__file__
_build.build()
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.core.policy import PALLAS_TILED  # noqa: E402
from repro_torch.data.pipeline import LMBatchSpec, lm_batch  # noqa: E402
from repro_torch.models.lm import model as LM  # noqa: E402
from repro_torch.optim import optimizers as opt  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402

dev, sync = "cuda", torch.cuda.synchronize
cfg = ARCHS["tinyllama-1.1b"]
pol = PALLAS_TILED.with_(straight_through=False)


def timed(fn, n):
    ms = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        sync()
        ms.append(a.elapsed_time(b))
    return ms


params = LM.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
eng = ServeEngine(params, cfg, policy=pol, prequant=pol, strict_backend=True,
                  slots=4, max_len=256, prefill_chunk=8, device=dev)
del params
g = torch.Generator().manual_seed(1)
toks = torch.randint(0, cfg.vocab_size, (4, 4), generator=g).to(dev)
cache = LM.init_cache(cfg, 4, 256, device=dev)
with torch.inference_mode():
    for i in range(4):
        _, cache = LM.decode_step(eng.plan.params, cfg, cache,
                                  toks[:, i:i + 1], i, eng.plan)
tok = toks[:, :1]
eng._step(cache, tok, 4)
sync()
pos = iter(range(5, 100))
dec = timed(lambda: eng._step(cache, tok, next(pos)), 20)
del eng, cache
torch.cuda.empty_cache()

state = TS.init_state(cfg, torch.Generator(device=dev).manual_seed(0),
                      device=dev)
spec = LMBatchSpec(vocab_size=cfg.vocab_size, seq_len=256, global_batch=8,
                   seed=0)
step = TS.make_train_step(cfg, opt.cosine_schedule(3e-4, 20, 100),
                          policy=pol)
box = [state]
for i in range(2):
    box[0], _ = step(box[0], lm_batch(spec, i, device=dev))
sync()
batches = [lm_batch(spec, 2 + i, device=dev) for i in range(5)]
it = iter(batches)


def one():
    box[0], _ = step(box[0], next(it))


trn = timed(one, 5)
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"], capture_output=True,
                      text=True).stdout.strip()
print("AB", json.dumps({"tree": sys.argv[2], "decode_ms_median":
                        statistics.median(dec), "decode_ms": dec,
                        "train_ms_median": statistics.median(trn),
                        "train_ms": trn, "card": card}), flush=True)
