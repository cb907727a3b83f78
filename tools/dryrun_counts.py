"""Per-device dry-run counts of a checkout, to hold a change to
``roofline.partition`` or the model code against its parent.

    python3 tools/dryrun_counts.py CHECKOUT OUT.json [ARCH:SHAPE,...] [CELLS]
    python3 tools/dryrun_counts.py --compare BEFORE.json AFTER.json

Imports ``repro_torch`` from ``CHECKOUT/src`` (this tree, or a ``git
archive`` of another commit unpacked elsewhere) and writes, per cell,
the trace's FLOPs, unfused bytes, collectives (kind, bytes) and memory:
reduced TinyLlama's prefill / decode / train cells (B 4, S 32) on fake
(2, 2) and (1, 4) meshes, each ARCH:SHAPE at one layer unit on the fake
16x16 mesh, and every variant of the hillclimb CELLS named (e.g.
``A,C``: their three roofline terms).  ``--compare`` prints the cells
whose counts differ.  Runs on the CPU; no device is touched.
"""
import json
import os
import sys
import warnings


def counts(root, cells, hill):
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.configs.base import SHAPES, ShapeConfig, reduced
    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import hillclimb as HC
    from repro_torch.launch.input_specs import build_cell, with_layer_units

    assert DR.__file__.startswith(os.path.abspath(root)), DR.__file__
    out = {}

    def record(key, trace):
        cost = trace.cost()
        out[key] = {"flops": cost["flops"],
                    "bytes": cost["bytes accessed"],
                    "collectives": sorted(map(list, trace.collectives)),
                    "memory": trace.memory()}
        print(key, cost, flush=True)

    tiny = reduced(ARCHS["tinyllama-1.1b"])
    for shape in ((2, 2), (1, 4)):
        with DR.fake_mesh(shape, ("data", "model")) as mesh:
            for kind in ("prefill", "decode", "train"):
                cell = build_cell(tiny, ShapeConfig(kind, 32, 4, kind), mesh)
                record(f"tiny{shape}{kind}", DR.trace_cell(cell, mesh))
    with DR.fake_mesh(*DR.MESHES["single_pod_16x16"]) as mesh:
        for c in cells:
            arch, shape = c.split(":")
            cell = build_cell(with_layer_units(ARCHS[arch], 1),
                              SHAPES[shape], mesh)
            record(c, DR.trace_cell(cell, mesh))
        for cid in hill:
            arch, shape, variants = HC.VARIANTS[cid]
            for name, kw, patch in variants:
                t = HC.measure(arch, shape, mesh, kw, patch)
                t.pop("compile_s")
                out[f"hillclimb {cid} {name}"] = t
                print(cid, name, t, flush=True)
    return out


def main(argv):
    warnings.filterwarnings("ignore")
    if argv[0] == "--compare":
        a, b = (json.load(open(p)) for p in argv[1:3])
        for key in sorted(set(a) | set(b)):
            if a.get(key) != b.get(key):
                print(f"DIFF {key}: {a.get(key)} -> {b.get(key)}")
        print(f"{len(a)} / {len(b)} cells compared")
        return
    cells = argv[2].split(",") if len(argv) > 2 and argv[2] else []
    hill = argv[3].split(",") if len(argv) > 3 else []
    with open(argv[1], "w") as f:
        json.dump(counts(argv[0], cells, hill), f, indent=1, default=str)


if __name__ == "__main__":
    main(sys.argv[1:])
