"""CNN serving launcher: batched BFP inference on a bound plan
(counterpart of ``repro.launch.serve_cnn``).

Admits image requests into the slot-table engine and serves them with
iteration-level batching on the bind-once plan, or as several
MULTI-TENANT models in one process:

  PYTHONPATH=src python -m repro_torch.launch.serve_cnn --model vgg16 \\
      --requests 32 --slots 8 --bfp --prequant
  PYTHONPATH=src python -m repro_torch.launch.serve_cnn --model resnet50 \\
      --scale full --requests 16 --bfp --prequant --strict-backend
  PYTHONPATH=src python -m repro_torch.launch.serve_cnn \\
      --tenants lenet,cifarnet --requests 12 --bfp
  PYTHONPATH=src python -m repro_torch.launch.serve_cnn --model vgg16 \\
      --mesh 1x1 --bfp --prequant --logits-out logits.npy

Runs on the card; ``--device cpu`` serves on the CPU (the kernels' plain
versions).  ``--mesh DxM`` serves on a (data, model) mesh of the
``--device``'s type with ``DEFAULT_RULES`` (the request batch split over
"data"); D * M must be the process group's world size (one process, so
1x1, unless the caller started a group).  ``--logits-out`` saves the
served logits, one row per request in request order, as a ``.npy``.  Weights come from ``torch.Generator`` seed 0 and images from
seed 1.  ``--bfp`` is the paper's policy (EQ4, L = 8) on the emulated
datapath, as in ``repro``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.policy import PAPER_DEFAULT
from repro_torch.dist.sharding import DEFAULT_RULES
from repro_torch.models.cnn import MODELS
from repro_torch.serve.cnn import CnnServeEngine, ImageRequest


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _serve_tenants(args, policy, dev):
    """Multi-tenant path: every listed model serves from one process."""
    from repro_torch.serve.tenants import MultiTenantServer

    names = [m.strip() for m in args.tenants.split(",") if m.strip()]
    bad = [m for m in names if m not in MODELS]
    if bad:
        raise SystemExit(f"unknown tenant model(s) {bad}; "
                         f"available: {sorted(MODELS)}")
    srv = MultiTenantServer(slots=args.slots, batching=args.batching,
                            max_wait=args.max_wait,
                            strict_backend=args.strict_backend, device=dev)
    for m in names:
        srv.add_tenant(m, m, params=MODELS[m].init(
            torch.Generator().manual_seed(0), device=dev),
            policy=policy, prequant=args.prequant)
    gen = torch.Generator().manual_seed(1)
    reqs = []
    for i in range(args.requests):
        m = names[i % len(names)]
        shape = MODELS[m].input_shape()
        reqs.append((m, srv.submit(
            m, ImageRequest(rid=i, image=torch.randn(shape, generator=gen)))))
    _sync(dev)
    t0 = time.perf_counter()
    srv.run()
    _sync(dev)
    dt = max(time.perf_counter() - t0, 1e-9)
    for m, r in reqs[:4]:
        print(f"req {r.rid} [{m}]: label={r.label}")
    st = srv.stats()
    for m in names:
        print(f"tenant {m}: {st['tenants'][m]}")
    print(f"{st['total']['completed']} requests across {len(names)} "
          f"tenants in {dt:.2f}s ({st['total']['completed'] / dt:.1f} "
          f"req/s) batching={args.batching}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve_cnn")
    ap.add_argument("--model", choices=sorted(MODELS),
                    help="single-tenant model (or use --tenants)")
    ap.add_argument("--tenants", metavar="M1,M2,...",
                    help="serve several models as tenants of one "
                         "process (round-robin traffic)")
    ap.add_argument("--scale", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--bfp", action="store_true",
                    help="BFP-8 activation x weight datapath per site")
    ap.add_argument("--prequant", action="store_true",
                    help="pre-quantize weights at bind (wire format)")
    ap.add_argument("--strict-backend", action="store_true",
                    help="refuse backend downgrades at admission")
    ap.add_argument("--mesh", metavar="DxM",
                    help="data x model mesh, e.g. 1x1 (device count must "
                         "match); shards the request batch axis")
    ap.add_argument("--batching", default="continuous",
                    choices=["continuous", "bucket"],
                    help="run partially-filled steps immediately vs the "
                         "bucket-barrier baseline")
    ap.add_argument("--max-wait", type=int, default=4,
                    help="bucket mode: deferred steps before a partial "
                         "batch runs anyway")
    ap.add_argument("--device", default="cuda",
                    help="where the engine serves (default cuda; cpu runs "
                         "the kernels' plain versions)")
    ap.add_argument("--logits-out", metavar="PATH",
                    help="save the served logits (request order) as .npy")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    policy = (PAPER_DEFAULT.with_(straight_through=False) if args.bfp
              else None)
    if args.tenants:
        _serve_tenants(args, policy, dev)
        return
    if not args.model:
        ap.error("pass --model (single tenant) or --tenants")

    spec = MODELS[args.model]
    reduced = args.scale == "smoke"
    params = spec.init(torch.Generator().manual_seed(0), reduced=reduced,
                       device=dev)
    mesh = None
    if args.mesh:
        from repro_torch.launch.mesh import make_mesh

        try:
            d, m = (int(v) for v in args.mesh.lower().split("x"))
            mesh = make_mesh((d, m), ("data", "model"),
                             device_type=dev.type)
        except ValueError as e:
            ap.error(f"--mesh {args.mesh}: {e}")
    eng = CnnServeEngine(params, spec.apply, policy, slots=args.slots,
                         prequant=args.prequant,
                         strict_backend=args.strict_backend,
                         batching=args.batching, max_wait=args.max_wait,
                         mesh=mesh, rules=DEFAULT_RULES, device=dev)
    print(f"bound plan: {eng.plan!r}")
    h, w, c = spec.input_shape(reduced=reduced)
    gen = torch.Generator().manual_seed(1)
    reqs = [eng.submit(ImageRequest(
        rid=i, image=torch.randn((h, w, c), generator=gen)))
        for i in range(args.requests)]
    # run EVERY bucket once off the clock (first launches build and cache
    # what they need), through a throwaway engine on the same plan —
    # Plan.jit_forward shares the forward
    warm = CnnServeEngine(None, spec.apply, eng.plan, slots=args.slots,
                          mesh=mesh, rules=DEFAULT_RULES, device=dev)
    for b in warm.buckets:
        for _ in range(b):
            warm.submit(image=torch.zeros((h, w, c)))
        warm.run()
    _sync(dev)
    t0 = time.perf_counter()
    eng.run()
    _sync(dev)
    dt = max(time.perf_counter() - t0, 1e-9)
    served = [r for r in reqs if r.done]
    for r in served[:4]:
        print(f"req {r.rid}: label={r.label}")
    if args.logits_out:
        np.save(args.logits_out, np.stack([r.logits for r in reqs]))
    print(f"{len(served)} requests in {dt:.2f}s "
          f"({len(served) / dt:.1f} req/s) model={args.model} "
          f"bfp={args.bfp} prequant={args.prequant} mesh={args.mesh}")


if __name__ == "__main__":
    main()
