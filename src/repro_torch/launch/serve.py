"""LM serving launcher (counterpart of ``repro.launch.serve``): --arch
<id>, the continuous-batching engine, optional BFP-8 datapath and
prequantized weights (the paper's deployment).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
      --requests 2 --max-new 4 --bfp --bfp-weights

Runs on the card; ``--device cpu`` serves on the CPU.  Weights are drawn
from ``torch.Generator`` seed 0 (architecture shapes only, no
checkpoint); ``--scale smoke`` (the default) is the reference's reduced
config (4 layers, d_model 128, d_ff 256, vocab 512).  ``--bfp`` is the
paper's policy (EQ4, L = 8) on the emulated datapath and
``--bfp-weights`` stores weights as int8 mantissas with TILED block-32
steps, as in ``repro``.  Every family serves: dense, vlm, moe, ssm
(``--arch rwkv6-3b``) and hybrid (``--arch recurrentgemma-9b``; at smoke
scale 4 layers: one (rec, rec, attn) period and one rec block).  The
encoder-decoder (``--arch seamless-m4t-medium``) fails here as in
``repro``: ``ServeEngine`` refuses it, and it is served through
``repro_torch.serve.engine.generate(enc_feats=)``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import ARCHS
from repro_torch.core.policy import BFPPolicy, PAPER_DEFAULT
from repro_torch.core.prequant import quantize_param_tree
from repro_torch.models.lm.model import init_params
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--scale", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--bfp", action="store_true",
                    help="BFP-8 activation x weight datapath per GEMM")
    ap.add_argument("--bfp-weights", action="store_true",
                    help="store weights as int8 mantissa + exponent sidecar")
    ap.add_argument("--batching", default="continuous",
                    choices=["continuous", "bucket"],
                    help="iteration-level batching (chunked prefill in "
                         "the step loop) vs the blocking-prefill bucket "
                         "baseline")
    ap.add_argument("--prefill-chunk", type=int, default=8,
                    help="prompt tokens a prefilling slot consumes per "
                         "step in continuous mode (0 = whole prompt)")
    ap.add_argument("--device", default="cuda",
                    help="where the engine serves (default cuda; cpu runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    base = ARCHS[args.arch]
    cfg = base if args.scale == "full" else reduced(
        base, n_layers=4, d_model=128, d_ff=256, vocab=512)
    params = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    if args.bfp_weights:
        params = quantize_param_tree(params, BFPPolicy(block_k=32))
    policy = PAPER_DEFAULT.with_(straight_through=False) if args.bfp else None

    eng = ServeEngine(params, cfg, slots=args.slots, max_len=args.max_len,
                      policy=policy, batching=args.batching,
                      prefill_chunk=args.prefill_chunk or None, device=dev)
    for i in range(args.requests):
        eng.submit(Request(rid=i, prompt=[1 + i, 7, 3], max_new=args.max_new))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    done = eng.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = max(time.perf_counter() - t0, 1e-9)
    toks = sum(len(r.out) for r in done)
    for r in done[:4]:
        print(f"req {r.rid}: {r.out}")
    print(f"{toks} tokens in {dt:.1f}s ({toks / dt:.1f} tok/s) "
          f"bfp={args.bfp} bfp_weights={args.bfp_weights}")


if __name__ == "__main__":
    main()
