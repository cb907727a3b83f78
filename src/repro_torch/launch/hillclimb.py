"""§Perf hillclimbing: named variations over the 3 chosen cells
(counterpart of ``repro.launch.hillclimb``).

Each variation re-traces the cell (roofline methodology: 1- and 2-unit
traces on fake tensors, exact extrapolation) and reports the three
roofline terms.

Cells (as in ``repro``):
  A  minicpm-2b prefill_32k      worst useful-FLOP ratio
  B  olmoe-1b-7b prefill_32k     most collective-bound runnable cell
  C  mistral-nemo-12b decode_32k most representative of the paper's
                                 technique (weight-streaming bound ->
                                 BFP-8 weights cut HBM+wire bytes)

Usage: PYTHONPATH=src python -m repro_torch.launch.hillclimb [--cell A B C]
Writes results/hillclimb/<cell>__<variant>.json.  Starts a ``"fake"``
process group of 256 ranks for the 16x16 mesh and destroys it on exit.
"""
from __future__ import annotations

import argparse
import json
import os
import time

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCHS
from repro_torch.core.policy import BFPPolicy
from repro_torch.launch import dryrun as DR
from repro_torch.launch.input_specs import (build_cell, layer_units,
                                            with_layer_units)
from repro_torch.roofline import analysis as RA

__all__ = ["VARIANTS", "measure", "main"]

_BFP8 = BFPPolicy(l_w=8, l_i=8, block_k=128)  # 128 divides every arch dim


def measure(arch, shape_name, mesh, build_kwargs, rules_patch=None):
    cfg, shape = ARCHS[arch], SHAPES[shape_name]
    units = layer_units(cfg)
    res = {}
    t0 = time.time()
    for u in (1, 2):
        cell = build_cell(with_layer_units(cfg, u), shape, mesh,
                          analysis_unroll=True, **build_kwargs)
        if rules_patch:
            cell.rules.update(rules_patch)
        res[u] = DR._extract(DR.trace_cell(cell, mesh))
    flops, bytes_, coll = DR.extrapolate(res, units)
    hw = RA.HW(chips=int(mesh.size()))
    terms = RA.roofline_terms({"flops": flops, "bytes accessed": bytes_},
                              coll, hw, n_links=RA.N_LINKS)
    terms["compile_s"] = round(time.time() - t0, 1)
    return terms


VARIANTS = {
    "A": ("minicpm-2b", "prefill_32k", [
        ("baseline", {}, None),
        # H: 36 heads % 16 != 0 -> attention replicated over model (16x
        # attn FLOPs/device).  Pad heads 36->48: +33% width, 16x sharding.
        ("pad_heads", dict(pad_heads=True), None),
        # H: and stream weights as BFP-8 (paper): HBM bytes drop further.
        ("pad_heads+bfp8w", dict(pad_heads=True, bfp_weights=_BFP8), None),
        # H: flash QK/PV operands in bf16 (f32 accumulate) halve the score
        # traffic that dominates prefill bytes (re-measures cell A).
        ("pad_heads+bf16_flash", dict(pad_heads=True), None),
    ]),
    "B": ("olmoe-1b-7b", "prefill_32k", [
        ("baseline", {}, None),
        # H: EP dispatch gathers token buffers; sharding experts over
        # (data x model) = 256-way spreads dispatch buffers AND turns the
        # expert all-gather into an all-to-all of 1/16 the payload.
        ("ep_2d", {}, {"experts": ("data", "model")}),
        # H: TP-inside-experts instead of EP (no token redistribution,
        # but replicated expert buffers) — expected to LOSE on memory.
        ("tp_experts", {}, {"experts": None, "ffn": "model"}),
    ]),
    "C": ("mistral-nemo-12b", "decode_32k", [
        ("baseline", {}, None),
        # H: FSDP at decode all-gathers every weight each step; inference
        # layout (TP only, replicated over data) kills those collectives.
        ("no_fsdp", dict(inference_no_fsdp=True), None),
        # H (paper): BFP-8 weight wire format halves HBM bytes vs bf16
        # and cuts any remaining weight traffic 2x; activation cost
        # unchanged.  The paper's off-chip-traffic claim, measured.
        ("no_fsdp+bfp8w", dict(inference_no_fsdp=True,
                               bfp_weights=_BFP8), None),
        ("bfp8w_only", dict(bfp_weights=_BFP8), None),
    ]),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", nargs="*", default=["A", "B", "C"])
    ap.add_argument("--out", default="results/hillclimb")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    with DR.fake_mesh(*DR.MESHES["single_pod_16x16"]) as mesh:
        for cid in args.cell:
            arch, shape, variants = VARIANTS[cid]
            for name, kwargs, rules_patch in variants:
                path = os.path.join(args.out, f"{cid}__{name}.json")
                if os.path.exists(path):
                    print(f"CACHED {cid} {name}", flush=True)
                    continue
                try:
                    t = measure(arch, shape, mesh, kwargs, rules_patch)
                    with open(path, "w") as f:
                        json.dump({"cell": cid, "arch": arch, "shape": shape,
                                   "variant": name, **t}, f, indent=1)
                    print(f"OK {cid} {name}: comp={t['t_compute']:.3f}s "
                          f"mem={t['t_memory']:.3f}s "
                          f"coll={t['t_collective']:.3f}s "
                          f"dom={t['dominant']}", flush=True)
                except Exception as e:
                    print(f"FAIL {cid} {name}: {type(e).__name__}: {e}",
                          flush=True)


if __name__ == "__main__":
    main()
