"""LM training launcher (counterpart of ``repro.launch.train``): --arch
<id> at full or scaled size.

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --scale smoke --steps 100 --ckpt-dir /tmp/ckpt [--bfp] \\
      [--compress-grads]

Trains on the card; ``--device cpu`` trains on the CPU.  ``--scale
full`` is the published config, ``smoke`` the reference's reduced one
(2 layers, d_model 64, d_ff 128, vocab 256) and ``100m`` 8 layers at
d_model 512, d_ff 2048, vocab 8192.  Params are drawn from
``torch.Generator`` seed 0.  ``--bfp`` is the paper's policy
(``PAPER_DEFAULT``: EQ4, L = 8, the emulated datapath, straight-through
gradients), and ``--compress-grads`` passes the gradients through the
8-bit error-feedback wire (``dist.compress.make_compressor``) before the
optimizer, as in ``repro``.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import ARCHS
from repro_torch.core.policy import PAPER_DEFAULT
from repro_torch.data.pipeline import LMBatchSpec
from repro_torch.dist.compress import make_compressor
from repro_torch.optim import optimizers as opt
from repro_torch.train.loop import LoopConfig, run_training
from repro_torch.train.step import init_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--scale", default="smoke", choices=["smoke", "100m",
                                                         "full"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default="cosine", choices=["cosine", "wsd",
                                                             "const"])
    ap.add_argument("--bfp", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="where the state and batches live (default cuda; "
                         "cpu runs the kernels' plain versions)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    base = ARCHS[args.arch]
    if args.scale == "full":
        cfg = base
    elif args.scale == "100m":
        cfg = reduced(base, n_layers=8, d_model=512, d_ff=2048, vocab=8192)
    else:
        cfg = reduced(base)

    state = init_state(cfg, torch.Generator().manual_seed(0), device=dev)
    sched = {"cosine": opt.cosine_schedule(args.lr, 20, args.steps),
             "wsd": opt.wsd_schedule(args.lr, 20, int(args.steps * 0.6),
                                     int(args.steps * 0.3)),
             "const": opt.constant_schedule(args.lr)}[args.schedule]

    grad_transform = None
    if args.compress_grads:
        init_fn, transform = make_compressor(bits=8)
        residual = [init_fn(state.params)]

        def grad_transform(grads):
            q, residual[0] = transform(grads, residual[0])
            return q

    step = make_train_step(cfg, sched,
                           policy=PAPER_DEFAULT if args.bfp else None,
                           grad_transform=grad_transform)
    spec = LMBatchSpec(vocab_size=cfg.vocab_size, seq_len=args.seq,
                       global_batch=args.batch)
    out = run_training(state, step, spec,
                       LoopConfig(total_steps=args.steps,
                                  ckpt_dir=args.ckpt_dir,
                                  ckpt_every=args.ckpt_every),
                       log_fn=lambda s, m: print(
                           f"step {s} loss {m['loss']:.4f}", flush=True))
    h = out["history"]
    print(f"done: loss {h[0]['loss']:.4f} -> {h[-1]['loss']:.4f}; "
          f"median step {out['median_step_s'] * 1e3:.0f} ms")


if __name__ == "__main__":
    main()
