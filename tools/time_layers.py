"""Time every BFP layer of one batch-8 forward of a model, for A/B runs.

    python3 tools/time_layers.py CHECKOUT MODEL OUT.json [--seed N]

Imports ``repro_torch`` from ``CHECKOUT/src`` (this tree, or a ``git
archive`` of another commit unpacked elsewhere), builds its kernels,
binds MODEL ("googlenet", "resnet50", ...) at full width with seeded
random weights under ``PALLAS_TILED`` (strict, prequantized), records
the conv and GEMM calls of one batch-8 forward and times each at its own
input with CUDA events (5 calls after one warm-up, as ``chip_smoke.py``
times its layers).  A layer's core is "mma" when the call launched a
format pass of the mma core (any counter whose name ends in "format":
the conv's and the GEMM's activation, patch, weight and output passes),
else "tile", read from the checkout's launch counters, so it is right
for any commit.  The rule holds here because every recorded call takes
f32 x, so a call on the core always runs a pass; a wire-x call with
prequant weights and an f32 output runs the core alone and would read
"tile" (no model served here makes one).  OUT.json holds
``{"card": ..., "layers": {"<MODEL>_full": {path: {"kernel", "core",
"shape", "ms"}}}}``, the layout ``tools/compare_layers.py`` reads.  Run
two checkouts in turns in one call (A, B, B, A) to compare them; needs a
CUDA card and nvcc.
"""
import argparse
import json
import os
import subprocess
import sys

import torch


def main() -> int:
    ap = argparse.ArgumentParser(prog="time_layers")
    ap.add_argument("checkout")
    ap.add_argument("model")
    ap.add_argument("out")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_layers: needs a CUDA card")
    sys.path.insert(0, os.path.join(os.path.abspath(args.checkout), "src"))
    from repro_torch import engine as EG
    from repro_torch import kernels as K
    from repro_torch.core.policy import PALLAS_TILED
    from repro_torch.core.prequant import is_prequant
    from repro_torch.kernels import _build
    from repro_torch.models.cnn import MODELS

    _build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(args.seed)
    model = MODELS[args.model]
    params = model.init(gen, reduced=False, device=dev)
    plan = EG.bind(params, PALLAS_TILED.with_(straight_through=False),
                   tree="cnn", strict=True, device=dev)
    hw = model.input_shape(reduced=False)[0]
    x = torch.randn((8, hw, hw, 3), generator=gen).to(dev)

    calls = []
    conv2d, gemm = plan.conv2d, plan.gemm

    def rec_conv(x, w, *, path=None, stride=1, padding="SAME", **kw):
        calls.append((path, lambda: conv2d(x, w, path=path, stride=stride,
                                           padding=padding), w, x))
        return conv2d(x, w, path=path, stride=stride, padding=padding, **kw)

    def rec_gemm(x, w, *, path=None, **kw):
        calls.append((path, lambda: gemm(x, w, path=path), w, x))
        return gemm(x, w, path=path, **kw)

    plan.conv2d, plan.gemm = rec_conv, rec_gemm
    with torch.inference_mode():
        model.apply(plan.params, x, plan)
        rows = {}
        for path, call, w, xin in calls:
            K.reset_launch_counts()
            out = call()
            counts = K.launch_counts()
            torch.cuda.synchronize()
            conv = xin.ndim == 4
            wt = w["m"] if is_prequant(w) else w
            n = wt.shape[-1]
            k = wt.numel() // n
            fmt = sum(v for c, v in counts.items() if c.endswith("format"))
            call()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):
                call()
            stop.record()
            torch.cuda.synchronize()
            rows[path] = {
                "kernel": (("bfp_conv2d" if conv else "bfp_matmul")
                           + ("_prequant" if is_prequant(w) else "")),
                "core": "mma" if fmt else "tile",
                "shape": [out.numel() // n, n, k],
                "ms": start.elapsed_time(stop) / 5}
    label = f"{args.model}_full"
    total = sum(r["ms"] for r in rows.values())
    print(f"time_layers {args.checkout} {label}: {len(rows)} layers, "
          f"{total:.4f} ms  [{card}]")
    with open(args.out, "w") as f:
        json.dump({"card": card, "layers": {label: rows}}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
