"""Time ResNet-50's offline weight formatting and VGG16's fc chains of a
checkout, for A/B runs on a card.

    python3 tools/time_format_chain.py CHECKOUT LABEL OUT.json [--seed N]

Imports ``repro_torch`` from ``CHECKOUT/src`` (this tree, or a ``git
archive`` of another commit unpacked elsewhere) and builds its kernels.

* ``resnet50_format`` (``chip_smoke.py`` phase 7): ResNet-50 at published
  width with seeded weights, bound under ``PALLAS_TILED``; each of the 45
  weights the plan prequantizes is formatted through ``ops.bfp_quantize``
  in the GEMM view ``[N, K]``.  Four numbers: ``loop_ms``, CUDA events
  around one loop of the 45 calls (mean of 20 loops after a warm-up);
  ``bare_ms``, the same for a loop of 45 bare ctypes launches of the
  kernel on outputs made once (the loop less this is wrapper host time);
  ``sum_ms``, the per-weight CUDA-event times summed (20 calls of each
  weight, as phase 7 times them); and under ``torch.profiler`` over 5
  loops, per loop, ``device_ms`` (the self device time of the
  ``bfp_quantize`` kernels) and ``device_all_ms`` (every kernel and
  copy the loop ran on the card: pad copies too).
* the fc stage of ``chip_smoke.py`` phase 6 at batch 8, block 128, L 8:
  fc6 (f32 x, the epilogue on), fc7 (wire x, the epilogue on) and fc8
  (wire x, f32 out) through ``engine.gemm``, with float weights (chain B,
  the x-prequant matmuls) and prequantized ones (chain A), each layer at
  a seeded input of its own shape, CUDA events over 20 calls.

Prints one summary line and writes ``{"card", "label", "format":
{...}, "chain": {"chain_A": {layer: ms}, "chain_B": {...}}}`` to
OUT.json.  Run two checkouts in turns (A, B, B, A, ...) in one call to
compare them; needs a CUDA card and nvcc.
"""
import argparse
import json
import os
import subprocess
import sys

import torch


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main() -> int:
    ap = argparse.ArgumentParser(prog="time_format_chain")
    ap.add_argument("checkout")
    ap.add_argument("label")
    ap.add_argument("out")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_format_chain: needs a CUDA card")
    sys.path.insert(0, os.path.join(os.path.abspath(args.checkout), "src"))
    from repro_torch import engine as EG
    from repro_torch.core.conv_utils import conv_weight_matrix
    from repro_torch.core.policy import PALLAS_TILED
    from repro_torch.core.prequant import prequant_act, prequant_leaf
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import bfp_quantize as KQ
    from repro_torch.models.cnn import MODELS

    _build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(args.seed)
    pol = PALLAS_TILED.with_(straight_through=False)

    # -- resnet50_format ----------------------------------------------------
    params = MODELS["resnet50"].init(gen, reduced=False, device=dev)
    plan = EG.bind(params, pol, tree="cnn", strict=True)

    def weight_at(tree, path):
        node = tree
        for key in path.split("/"):
            node = node[int(key)] if isinstance(node, (list, tuple)) else \
                node[key]
        return (node["conv"] if "bn" in node else node)["w"]

    views = []
    for path, site in plan.sites.items():
        if site.prequantized:
            w = weight_at(params, path)
            w = conv_weight_matrix(w) if w.ndim == 4 else w
            views.append(w.t().contiguous())

    def loop():
        for v in views:
            ops.bfp_quantize(v, 8, pol.block_k)

    # the bare launches: the kernel's ctypes entry point on outputs made
    # once, so the loop's time less this one is the wrappers' host time
    bq = pol.block_k
    outs = [ops.bfp_quantize(v, 8, bq) for v in views]
    lib, stream = KQ._lib(), torch.cuda.current_stream().cuda_stream
    bare_args = [(v.data_ptr(), m.data_ptr(), e.data_ptr(), v.shape[0],
                  v.shape[1], bq, 8, stream) for v, (m, e) in zip(views, outs)]

    def bare():
        for a in bare_args:
            lib.bfp_quantize_launch(*a)

    fmt = {"weights": len(views), "loop_ms": cuda_ms(loop, 20),
           "bare_ms": cuda_ms(bare, 20),
           "sum_ms": sum(cuda_ms(lambda: ops.bfp_quantize(v, 8, bq), 20)
                         for v in views)}
    loop()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(5):
            loop()
        torch.cuda.synchronize()
    # device-side events only (kernels, copies): a host op's row repeats
    # the device time of the kernels it launched
    dev_us = [(e.key, e.self_device_time_total, e.count)
              for e in prof.key_averages()
              if e.self_device_time_total > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    fmt["device_ms"] = sum(t for k, t, _ in dev_us
                           if "bfp_quantize" in k) / 1e3 / 5
    fmt["device_all_ms"] = sum(t for _, t, _ in dev_us) / 1e3 / 5
    fmt["device_kernels"] = {k[:80]: {"ms_per_loop": t / 1e3 / 5,
                                      "launches_per_loop": c / 5}
                             for k, t, c in dev_us}

    # -- the fc stage of the chains ------------------------------------------
    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    ws = {"fc6": rnd(25088, 4096, scale=0.009),
          "fc7": rnd(4096, 4096, scale=0.02),
          "fc8": rnd(4096, 1000, scale=0.02)}
    xs = {"fc6": torch.relu(rnd(8, 25088)),
          "fc7": prequant_act(torch.relu(rnd(8, 4096)), pol),
          "fc8": prequant_act(torch.relu(rnd(8, 4096)), pol)}
    chain = {}
    with torch.inference_mode():
        for label, prequant in (("chain_A", True), ("chain_B", False)):
            rows = chain[label] = {}
            for name, opol in (("fc6", pol), ("fc7", pol), ("fc8", None)):
                w = prequant_leaf(ws[name], pol) if prequant else ws[name]
                x = xs[name]
                rows[name] = cuda_ms(lambda: EG.gemm(x, w, pol,
                                                     out_policy=opol), 20)
    with open(args.out, "w") as f:
        json.dump({"card": card, "label": args.label, "format": fmt,
                   "chain": chain}, f, indent=1)
    print(f"{args.label} resnet50_format {fmt['weights']} weights: loop "
          f"{fmt['loop_ms']:.4f} ms, bare launches {fmt['bare_ms']:.4f} ms, "
          f"per-weight sum {fmt['sum_ms']:.4f} ms, "
          f"device bfp_quantize {fmt['device_ms']:.4f} ms, device all "
          f"{fmt['device_all_ms']:.4f} ms; chain fc6/fc7/fc8 A "
          + "/".join(f"{v:.4f}" for v in chain["chain_A"].values())
          + " B " + "/".join(f"{v:.4f}" for v in chain["chain_B"].values())
          + f" ms  [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
