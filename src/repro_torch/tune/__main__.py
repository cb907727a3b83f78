"""CLI: tune the canonical VGG-16 / ResNet-18 layers' tiles, or search
per-site mantissa widths (counterpart of ``python -m repro.tune``).

    PYTHONPATH=src python -m repro_torch.tune [--out tune_cache.json]
        [--smoke] [--hw 32] [--block-k 128] [--max-steps 12]
        [--device cuda|cpu]

Skips sites already in the cache (delete the file to retune) and saves
after every site.  On the card the entries carry the target
``tune.cache.CARD_TARGET``; with ``--device cpu`` the plain versions'
``"interpret"``.

    PYTHONPATH=src python -m repro_torch.tune --precision --model vgg16 \\
        [--budget 1e-2] [--top1-tol 0.25] [--l-max 8] [--l-min 2] \\
        [--seed 0] [--batch 8] [--policy-out policy.json] \\
        [--checkpoint-out ckpt_dir] [--device cuda|cpu]

emits the winning PolicyMap (with per-site NSR evidence) as JSON and,
with ``--checkpoint-out``, the ``bfp_packed_v2`` checkpoint packed under
that map.  Both modes run on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch._device import resolve_device
from repro_torch.core.policy import BFPPolicy, Scheme
from repro_torch.tune.autotune import tune_conv, tune_gemm
from repro_torch.tune.cache import TuneCache
from repro_torch.tune.shapes import CONV_LAYERS, GEMM_LAYERS


def _main_precision(args) -> None:
    from repro_torch.checkpoint import store
    from repro_torch.models.cnn import MODELS
    from repro_torch.tune.precision import search_precision

    res = search_precision(args.model, seed=args.seed, batch=args.batch,
                           l_max=args.l_max, l_min=args.l_min,
                           nsr_budget=args.budget, top1_tol=args.top1_tol,
                           verbose=True, device=args.device)
    for s in res.sites:
        print(f"[precision] {s.path:24s} {s.kind:4s} l_w={s.l_w} "
              f"nsr={s.nsr_measured:.3g} (budget {res.nsr_budget:g}) "
              f"fresh={s.nsr_fresh:.3g} <= bound={s.nsr_bound:.3g}",
              flush=True)
    print(f"[precision] top-1 agreement {res.top1_agreement:.3f} "
          f"(tol {res.top1_tol:g}), {res.n_evals} evals", flush=True)
    if args.policy_out:
        res.save(args.policy_out)
        print(f"[precision] PolicyMap + report -> {args.policy_out}",
              flush=True)
    if args.checkpoint_out:
        params = MODELS[args.model].init(
            torch.Generator().manual_seed(args.seed), device=args.device)
        path = store.save(args.checkpoint_out, 0, params,
                          format="bfp_packed_v2", policy=res.policy_map,
                          tree_kind="cnn")
        print(f"[precision] bfp_packed_v2 checkpoint -> {path}",
              flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(prog="repro_torch.tune")
    ap.add_argument("--out", default="tune_cache.json")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny spatial extent + fewer steps (CI)")
    ap.add_argument("--hw", type=int, default=None,
                    help="conv spatial extent (default 32, smoke 8)")
    ap.add_argument("--block-k", type=int, default=128)
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--precision", action="store_true",
                    help="per-site mantissa-width search (repro_torch.tune."
                         "precision) instead of tile tuning")
    ap.add_argument("--model", default="lenet",
                    help="precision mode: registry model name")
    ap.add_argument("--budget", type=float, default=1e-2,
                    help="precision mode: max per-site output NSR")
    ap.add_argument("--top1-tol", type=float, default=0.25,
                    help="precision mode: tolerated top-1 disagreement "
                         "fraction vs the global-l_max baseline")
    ap.add_argument("--l-max", type=int, default=8)
    ap.add_argument("--l-min", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--policy-out", default=None,
                    help="precision mode: write PolicyMap JSON here")
    ap.add_argument("--checkpoint-out", default=None,
                    help="precision mode: write the bfp_packed_v2 "
                         "checkpoint here")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args()
    resolve_device(args.device)

    if args.precision:
        _main_precision(args)
        return

    hw = args.hw or (8 if args.smoke else 32)
    steps = args.max_steps or (4 if args.smoke else 12)
    pol = BFPPolicy(scheme=Scheme.TILED, block_k=args.block_k,
                    straight_through=False)
    cache = TuneCache.load(args.out)
    print(f"[tune] cache {args.out}: {len(cache)} entries", flush=True)

    for name, b, k, n in GEMM_LAYERS:
        # the pinned block must divide K; free it (None) where it does
        # not, so bk is tuned instead
        p = pol if k % args.block_k == 0 else pol.with_(block_k=None)
        ent = tune_gemm(b, k, n, p, cache=cache, max_steps=steps,
                        device=args.device)
        cache.save()
        print(f"[tune] gemm {name:24s} ({b},{k},{n}) -> "
              f"bm={ent['bm']} bn={ent['bn']} bk={ent['bk']} "
              f"{ent['us']:.0f}us", flush=True)

    for name, c, oc, kk, stride in CONV_LAYERS:
        p = pol if (kk * kk * c) % args.block_k == 0 \
            else pol.with_(block_k=c if c <= args.block_k else None)
        ent = tune_conv(1, hw, hw, c, kk, oc, p, stride=stride,
                        cache=cache, max_steps=steps, device=args.device)
        cache.save()
        tile = (f"t_oh={ent['t_oh']}" if "t_oh" in ent
                else f"bm={ent['bm']}")
        print(f"[tune] conv {name:24s} (hw={hw},C={c},OC={oc},k={kk},"
              f"s={stride}) -> {tile} bn={ent['bn']} {ent['us']:.0f}us",
              flush=True)

    print(f"[tune] done: {cache!r}", flush=True)


if __name__ == "__main__":
    main()
