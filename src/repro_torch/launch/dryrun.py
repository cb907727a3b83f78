"""Multi-device dry run (counterpart of ``repro.launch.dryrun``): trace
every (arch x shape) cell on the production meshes and extract its cost,
collectives and memory per device.

No device is touched: each cell's step runs once under
``FakeTensorMode`` with its inputs placed as ``DTensor``s of a
``DeviceMesh`` over a ``"fake"`` process group (256 ranks for the
16x16 mesh, 512 for 2x16x16), and ``roofline.counter`` counts what one
device does (the stand-in for a compiled program's analyses).  Nothing
starts a process group at import: :func:`main` starts a fake one per
mesh and destroys it when that mesh is done.

Two modes (both resumable via --skip-existing; one JSON per cell), with
``repro``'s keys:

  --mode compile   (default) the full-depth model.  An eager trace runs
      every layer, so the ``*_scan_counted_once`` entries (``repro``'s
      names, kept for the schema) hold the whole step's count here.

  --mode roofline  per-step cost terms by layer-unit scaling: trace the
      model at 1 and 2 layer-units (full width, full shapes) and
      extrapolate F(L) = F1 + (L-1)(F2 - F1), exact because every unit
      is identical.  Collective byte counts extrapolate the same way.

A layer stack's leading [L] dim is placed replicated even where its spec
shards it (``dist.specs`` shards a stacked [L, d] norm over the data
axes when they divide L): the port runs its layers by unbinding each
stack, which DTensor does not do across a sharded dim.  At 1 and 2
units no production data axis divides L, so roofline mode places
exactly what the specs say.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mode roofline --mesh single
  ... --arch mixtral-8x7b --shape train_4k --out results/dryrun
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import traceback

from repro_torch import _tree
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCHS
from repro_torch.launch.input_specs import (_is_spec, build_cell,
                                            layer_units, with_layer_units)
from repro_torch.roofline import analysis as RA
from repro_torch.roofline import counter as CT
from repro_torch.roofline import partition as PT

__all__ = ["run_cell_compile", "run_cell_roofline", "fake_mesh", "place",
           "trace_cell", "extrapolate", "main"]

#: Param subtrees stacked over layers ([L, ...] leaves).
_STACKS = ("layers", "enc", "dec", "periods")


@contextlib.contextmanager
def fake_mesh(shape, axes, device_type: str = "cpu"):
    """A ``DeviceMesh`` of ``shape`` over a ``"fake"`` process group of as
    many ranks, destroyed on exit (no other group may be running)."""
    import math

    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_mesh

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        yield make_mesh(shape, axes, device_type=device_type)
    finally:
        dist.destroy_process_group()


def _placed_spec(path, spec):
    keys = [str(k) for k in path]
    if spec and any(k in _STACKS for k in keys):
        return (None,) + tuple(spec[1:])
    return spec


def place(args, in_specs, mesh):
    """``args`` (tensor trees: fake or real) placed on ``mesh`` by their
    spec trees, as ``DTensor``s; 0-d leaves stay plain (replicated), and
    so does everything on a mesh of one device, where a shard is the
    whole tensor and DTensor would only add its dispatch."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.dist.sharding import placements

    if mesh.size() == 1:
        return args
    specs = {_tree.keystr(p): s for p, s in
             _tree.leaves_with_path(in_specs, is_leaf=_is_spec)}

    def one(path, leaf):
        if not hasattr(leaf, "ndim") or leaf.ndim == 0:
            return leaf
        spec = _placed_spec(path, specs[_tree.keystr(path)])
        return distribute_tensor(leaf, mesh, placements(mesh, spec),
                                 src_data_rank=None)

    return _tree.map_with_path(one, args)


def trace_cell(cell, mesh) -> CT.Trace:
    """One traced run of ``cell.fn`` on fake DTensors of ``mesh`` under
    the cell's axis rules and ``roofline.partition``'s SPMD rules."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    fm = FakeTensorMode(allow_non_fake_inputs=True)
    fakes = _tree.tree_map(
        lambda t: CT.fake_like(t, fm, mesh.device_type)
        if hasattr(t, "shape") else t, tuple(cell.args))
    with fm:
        args = place(fakes, tuple(cell.in_specs), mesh)
    if mesh.size() == 1:
        return CT.trace(cell.fn, args, fm)
    with PT.spmd():
        return CT.trace(cell.fn, args, fm, mesh=mesh, rules=cell.rules)


def _compile_cell(cfg, shape, mesh, analysis_unroll):
    """Build the cell and trace it (``repro`` lowers and compiles here)."""
    cell = build_cell(cfg, shape, mesh, analysis_unroll=analysis_unroll)
    return trace_cell(cell, mesh)


def _extract(compiled: CT.Trace):
    """(cost, collectives, memory) of a trace, in ``repro``'s dicts."""
    return (compiled.cost(), RA.collective_bytes(compiled.collectives),
            compiled.memory())


def _model_flops(cfg, shape):
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len
                                   if shape.kind != "decode" else 1)
    factor = 6 if shape.kind == "train" else 2
    return factor * n_active * tokens


def run_cell_compile(arch, shape_name, mesh, mesh_name, out_dir):
    cfg, shape = ARCHS[arch], SHAPES[shape_name]
    t0 = time.time()
    compiled = _compile_cell(cfg, shape, mesh, analysis_unroll=False)
    t_compile = time.time() - t0
    cost, coll, mem = _extract(compiled)
    result = {
        "mode": "compile", "arch": arch, "shape": shape_name,
        "mesh": mesh_name, "n_devices": int(mesh.size()),
        "compile_s": round(t_compile, 1),
        "memory_analysis": mem,
        "cost_analysis_scan_counted_once": cost,
        "collective_bytes_scan_counted_once": coll,
        "params": int(cfg.param_count()),
        "status": "ok",
    }
    _write(out_dir, mesh_name, arch, shape_name, "compile", result)
    return result


def extrapolate(res, units):
    """(flops, bytes, collectives) at ``units`` layer-units from the
    1- and 2-unit ``_extract`` results ``res``."""
    def corr(metric_fn):
        f1, f2 = metric_fn(res[1]), metric_fn(res[2])
        return f1 + (units - 1) * (f2 - f1)

    flops = corr(lambda r: r[0].get("flops", 0.0))
    bytes_ = corr(lambda r: r[0].get("bytes accessed", 0.0))
    coll_kinds = set(res[1][1]) | set(res[2][1])
    coll = {k: int(corr(lambda r: float(r[1].get(k, 0))))
            for k in coll_kinds if not isinstance(res[1][1].get(k), str)}
    return flops, bytes_, coll


def run_cell_roofline(arch, shape_name, mesh, mesh_name, out_dir):
    cfg, shape = ARCHS[arch], SHAPES[shape_name]
    units = layer_units(cfg)
    t0 = time.time()
    res = {}
    for u in (1, 2):
        compiled = _compile_cell(with_layer_units(cfg, u), shape, mesh,
                                 analysis_unroll=True)
        res[u] = _extract(compiled)
    t_compile = time.time() - t0
    flops, bytes_, coll = extrapolate(res, units)

    n = int(mesh.size())
    hw = RA.HW(chips=n)
    terms = RA.roofline_terms({"flops": flops, "bytes accessed": bytes_},
                              coll, hw, n_links=RA.N_LINKS)
    model_flops = _model_flops(cfg, shape)
    hlo_total = flops * n
    result = {
        "mode": "roofline", "arch": arch, "shape": shape_name,
        "mesh": mesh_name, "n_devices": n,
        "layer_units": units, "compile_s": round(t_compile, 1),
        "cost_analysis": {"flops": flops, "bytes_accessed": bytes_},
        "collective_bytes": coll,
        "roofline": terms,
        "model_flops": model_flops,
        "useful_flop_ratio": model_flops / hlo_total if hlo_total else 0.0,
        "params": int(cfg.param_count()),
        "status": "ok",
    }
    _write(out_dir, mesh_name, arch, shape_name, "roofline", result)
    return result


def _write(out_dir, mesh_name, arch, shape_name, mode, result):
    path = os.path.join(out_dir, mesh_name,
                        f"{arch}__{shape_name}.{mode}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(result, f, indent=1)


#: name -> (shape, axes) of the production meshes.
MESHES = {"single_pod_16x16": ((16, 16), ("data", "model")),
          "multi_pod_2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--mode", default="compile",
                    choices=["compile", "roofline"])
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    meshes = []
    if args.mesh in ("single", "both"):
        meshes.append("single_pod_16x16")
    if args.mesh in ("multi", "both"):
        meshes.append("multi_pod_2x16x16")
    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    runner = (run_cell_compile if args.mode == "compile"
              else run_cell_roofline)

    failures = 0
    for mesh_name in meshes:
        with fake_mesh(*MESHES[mesh_name]) as mesh:
            for arch in archs:
                cfg = ARCHS[arch]
                for shape_name in shapes:
                    if shape_name == "long_500k" and not cfg.sub_quadratic:
                        print(f"SKIP  {mesh_name} {arch} {shape_name} "
                              f"(quadratic attn; DESIGN.md §4)", flush=True)
                        continue
                    path = os.path.join(
                        args.out, mesh_name,
                        f"{arch}__{shape_name}.{args.mode}.json")
                    if args.skip_existing and os.path.exists(path):
                        print(f"CACHED {mesh_name} {arch} {shape_name}",
                              flush=True)
                        continue
                    try:
                        r = runner(arch, shape_name, mesh, mesh_name,
                                   args.out)
                        extra = ""
                        if args.mode == "roofline":
                            t = r["roofline"]
                            extra = (f" flops={t['hlo_flops']:.3g}"
                                     f" dom={t['dominant']}"
                                     f" useful={r['useful_flop_ratio']:.2f}")
                        print(f"OK    {mesh_name} {arch} {shape_name} "
                              f"compile={r['compile_s']}s{extra}",
                              flush=True)
                    except Exception as e:
                        failures += 1
                        print(f"FAIL  {mesh_name} {arch} {shape_name}: "
                              f"{type(e).__name__}: {e}", flush=True)
                        traceback.print_exc()
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
