"""``repro_torch.launch.dryrun`` and ``launch.hillclimb`` against
``repro``'s on the CPU.

* ``_model_flops`` equal for every architecture x shape; ``VARIANTS``
  (cells, variant names, build keywords, rule patches) equal.
* ``run_cell_roofline`` of ``reduced()`` TinyLlama at 4 layers on a fake
  (2, 2) mesh: the 1- and 2-unit extrapolation of flops, bytes and
  collectives equals a direct trace of all 4 layers (an eager trace
  counts every layer, which ``repro``'s scanned compile could not).
* The JSONs carry ``repro``'s keys: ``run_cell_roofline`` and
  ``run_cell_compile`` of a reduced cell on a one-device mesh, both
  packages (``repro`` on a one-device ``jax`` mesh).
* ``main`` (roofline mode, the fake 16x16 mesh) and ``hillclimb.measure``
  run on a reduced architecture.

``repro``'s dry-run modules set ``XLA_FLAGS`` for 512 host devices when
imported; they are imported with the variable restored at once, before
this process's ``jax`` backend reads it.  Every fake process group is
destroyed by the test that starts it.
"""
import dataclasses
import enum
import importlib
import json
import os

import jax
import pytest

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import reduced as jreduced
from repro.configs.registry import ARCHS as JARCHS
from repro_torch.configs.base import SHAPES, ShapeConfig, reduced
from repro_torch.configs.registry import ARCHS
from repro_torch.launch import dryrun as DR
from repro_torch.launch import hillclimb as HC
from repro_torch.launch.input_specs import with_layer_units


def _import_keeping_xla_flags(name):
    before = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(name)
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before


JDR = _import_keeping_xla_flags("repro.launch.dryrun")
JHC = _import_keeping_xla_flags("repro.launch.hillclimb")

SMALL = ShapeConfig("prefill_s", 32, 4, "prefill")


def test_model_flops_equal_repro():
    for arch in ARCHS:
        for sname in SHAPES:
            assert DR._model_flops(ARCHS[arch], SHAPES[sname]) == \
                JDR._model_flops(JARCHS[arch], JSHAPES[sname])


def test_variants_equal_repro():
    def plain(x):
        return x.value if isinstance(x, enum.Enum) else x

    def norm(v):
        return {k: ({f: plain(y) for f, y in dataclasses.asdict(x).items()}
                    if dataclasses.is_dataclass(x) else x)
                for k, x in v.items()}
    assert set(HC.VARIANTS) == set(JHC.VARIANTS)
    for cid, (arch, shape, variants) in HC.VARIANTS.items():
        jarch, jshape, jvariants = JHC.VARIANTS[cid]
        assert (arch, shape) == (jarch, jshape)
        assert [(n, norm(kw), rp) for n, kw, rp in variants] == \
            [(n, norm(kw), rp) for n, kw, rp in jvariants]
    assert norm({"p": HC._BFP8}) == norm({"p": JHC._BFP8})


def _patch(monkeypatch, name, cfg, shape, *mods):
    for mod in mods:
        monkeypatch.setitem(mod.ARCHS, name, cfg)
        monkeypatch.setitem(mod.SHAPES, shape.name, shape)


def test_roofline_extrapolation_equals_the_full_depth_trace(
        monkeypatch, tmp_path):
    cfg = reduced(ARCHS["tinyllama-1.1b"], n_layers=4)
    _patch(monkeypatch, "tiny4", cfg, SMALL, DR)
    with DR.fake_mesh((2, 2), ("data", "model")) as mesh:
        r = DR.run_cell_roofline("tiny4", SMALL.name, mesh, "fake_2x2",
                                 str(tmp_path))
        full = DR._extract(DR._compile_cell(cfg, SMALL, mesh,
                                            analysis_unroll=True))
    assert r["layer_units"] == 4 and r["n_devices"] == 4
    cost, coll, _ = full
    assert r["cost_analysis"] == {"flops": cost["flops"],
                                  "bytes_accessed": cost["bytes accessed"]}
    assert r["collective_bytes"] == coll and coll
    assert r["roofline"]["hlo_flops"] == cost["flops"]
    # per device: a quarter of the one-device count
    with DR.fake_mesh((1, 1), ("data", "model")) as mesh1:
        one = DR._compile_cell(cfg, SMALL, mesh1, analysis_unroll=True)
    assert one.flops == 4 * cost["flops"]
    saved = json.loads((tmp_path / "fake_2x2" /
                        f"tiny4__{SMALL.name}.roofline.json").read_text())
    assert saved == json.loads(json.dumps(r))


def _keys(d, prefix=""):
    """Key paths of a result JSON; collective kinds (data, not schema)
    left out."""
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict) and not k.startswith("collective_bytes"):
            out |= _keys(v, prefix + k + ".")
    return out


#: ``compile``'s cost dict: ``repro`` stores XLA's whole
#: ``cost_analysis()`` (per-operand and utilization entries that only XLA
#: has); the port stores the two keys the roofline reads, which XLA's has.
_XLA_COST = "cost_analysis_scan_counted_once."


def test_json_keys_equal_repro(monkeypatch, tmp_path):
    cfg = reduced(ARCHS["tinyllama-1.1b"])
    jcfg = jreduced(JARCHS["tinyllama-1.1b"])
    _patch(monkeypatch, "tiny", cfg, SMALL, DR)
    jshape = JShape(SMALL.name, SMALL.seq_len, SMALL.global_batch,
                    SMALL.kind)
    _patch(monkeypatch, "tiny", jcfg, jshape, JDR)
    jmesh = jax.make_mesh((1, 1), ("data", "model"),
                          axis_types=(jax.sharding.AxisType.Auto,) * 2)
    with DR.fake_mesh((1, 1), ("data", "model")) as mesh:
        for mode in ("roofline", "compile"):
            run = getattr(DR, f"run_cell_{mode}")
            jrun = getattr(JDR, f"run_cell_{mode}")
            got = run("tiny", SMALL.name, mesh, "m", str(tmp_path / "p"))
            want = jrun("tiny", SMALL.name, jmesh, "m", str(tmp_path / "r"))
            mine, theirs = _keys(got), _keys(want)
            assert {k for k in mine if not k.startswith(_XLA_COST)} == \
                {k for k in theirs if not k.startswith(_XLA_COST)}, mode
            assert {k for k in mine if k.startswith(_XLA_COST)} <= theirs
            if mode == "roofline":
                assert got["model_flops"] == want["model_flops"]
                assert got["cost_analysis"]["flops"] > 0
            names = sorted(os.listdir(tmp_path / "p" / "m"))
            assert names == sorted(os.listdir(tmp_path / "r" / "m"))


def test_main_and_hillclimb_measure_run_on_a_reduced_arch(
        monkeypatch, tmp_path, capsys):
    import torch.distributed as dist

    cfg = reduced(ARCHS["tinyllama-1.1b"])
    shape = ShapeConfig("prefill_s", 32, 16, "prefill")
    _patch(monkeypatch, "tiny", cfg, shape, DR, HC)
    with pytest.raises(SystemExit) as e:
        DR.main(["--arch", "tiny", "--shape", shape.name, "--mesh",
                 "single", "--mode", "roofline", "--out", str(tmp_path)])
    assert e.value.code == 0 and not dist.is_initialized()
    out = capsys.readouterr().out
    assert out.startswith("OK    single_pod_16x16 tiny prefill_s"), out
    r = json.loads((tmp_path / "single_pod_16x16" /
                    "tiny__prefill_s.roofline.json").read_text())
    assert r["n_devices"] == 256 and r["roofline"]["dominant"] in (
        "compute", "memory", "collective")
    with DR.fake_mesh((2, 2), ("data", "model")) as mesh:
        t = HC.measure("tiny", shape.name, mesh,
                       dict(inference_no_fsdp=True), {"batch": "data"})
    assert t["t_compute"] > 0 and "compile_s" in t
    assert with_layer_units(cfg, 2).n_layers == 2
