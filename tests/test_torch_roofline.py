"""``repro_torch.roofline`` against ``repro.roofline`` on the CPU.

* ``roofline_terms`` and ``_wire_bytes`` equal ``repro``'s on a grid of
  costs, collectives and device counts, with ``repro``'s ``HW()`` fields
  passed in; the port's own ``HW()`` holds the H100's figures.
* ``collective_bytes`` of known redistributions on a fake (2, 2) mesh
  (all-gather, all-reduce, reduce-scatter of a [8, 16] f32 DTensor)
  equals ``repro.roofline.analysis.collective_bytes`` of hand-written
  HLO lines with the same result shapes.
* The per-device trap: ``(x @ w) @ w2`` sharded on a fake 16x16 mesh
  counts 2,097,152 FLOPs per device (``FlopCounterMode`` around the same
  DTensor call counts the sharding propagation's global-shape calls too).
* One local ``mm`` counts (MK + KN + MN) * itemsize bytes and 2MNK FLOPs.
* ``hlo_flops.dot_flops`` totals of ``reduced()`` TinyLlama's prefill and
  train cells on a 1x1 mesh equal ``repro.roofline.hlo_flops.dot_flops``
  of the same cells' compiled HLO, exactly (prefill as compiled; train
  without the dots ``repro``'s step has and the port's has not, named in
  the test).
* ``report.render`` prints what ``repro``'s prints over the same JSONs.
* What the dry run traces computes the right values: reduced TinyLlama's
  cells placed by their specs on four spawned ``gloo`` ranks agree with
  the plain run within bf16's rounding (``TOL``).
* ``roofline.partition.spmd`` leaves the model code as it found it, and
  refuses attention whose head shards straddle KV groups unevenly.

Every test that starts a fake process group destroys it.
"""
import dataclasses
import json
import os
import re

import jax
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import reduced as jreduced
from repro.configs.registry import ARCHS as JARCHS
from repro.dist.sharding import axis_rules as j_axis_rules
from repro.launch.input_specs import build_cell as j_build_cell
from repro.roofline import analysis as JRA
from repro.roofline import hlo_flops as JHF
from repro.roofline import report as JREP
from repro_torch.configs.base import ShapeConfig, reduced
from repro_torch.configs.registry import ARCHS
from repro_torch.launch import dryrun as DR
from repro_torch.launch.input_specs import build_cell
from repro_torch.roofline import analysis as RA
from repro_torch.roofline import counter as CT
from repro_torch.roofline import hlo_flops as HF
from repro_torch.roofline import report as REP


def _jhw(**kw):
    return RA.HW(**dict(dataclasses.asdict(JRA.HW()), **kw))


def test_hw_is_the_h100():
    hw = RA.HW()
    assert (hw.peak_flops, hw.hbm_bw, hw.ici_bw, hw.chips) == \
        (989.4e12, 3.35e12, 25e9, 1)
    assert RA.N_LINKS == 18
    assert [f.name for f in dataclasses.fields(RA.HW)] == \
        [f.name for f in dataclasses.fields(JRA.HW)]


@pytest.mark.parametrize("chips", [1, 4, 256, 512])
def test_roofline_terms_and_wire_bytes_equal_repro(chips):
    colls = [{}, {"all-gather": 1 << 20}, {"all-reduce": 3 << 20,
                                           "reduce-scatter": 5 << 10},
             {"all-to-all": 7 << 16, "collective-permute": 123,
              "all-gather": 99}]
    costs = [{}, {"flops": 1e12}, {"bytes accessed": 4e9},
             {"flops": 3.3e15, "bytes accessed": 1.2e11}]
    for coll in colls:
        assert RA._wire_bytes(coll, chips) == JRA._wire_bytes(coll, chips)
        for cost in costs:
            for n_links in (1, 4, RA.N_LINKS):
                got = RA.roofline_terms(cost, coll, _jhw(chips=chips),
                                        n_links=n_links)
                want = JRA.roofline_terms(cost, coll, JRA.HW(chips=chips),
                                          n_links=n_links)
                assert got == want


def _fake_mode():
    return FakeTensorMode(allow_non_fake_inputs=True)


def test_collective_bytes_of_redistributions_equal_repro():
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard)
    with DR.fake_mesh((2, 2), ("data", "model")) as mesh:
        fm = _fake_mode()
        with fm:
            a = DTensor.from_local(torch.empty(4, 16), mesh,
                                   [Shard(0), Replicate()])
            b = DTensor.from_local(torch.empty(8, 16), mesh,
                                   [Replicate(), Partial()])
            c = DTensor.from_local(torch.empty(8, 16), mesh,
                                   [Replicate(), Partial()])
        rep = [Replicate(), Replicate()]
        t = CT.trace(lambda a, b, c: (
            a.redistribute(mesh, rep), b.redistribute(mesh, rep),
            c.redistribute(mesh, [Replicate(), Shard(0)])), (a, b, c), fm,
            mesh=mesh)
    hlo = "\n".join([
        "%ag = f32[8,16]{1,0} all-gather(f32[4,16]{1,0} %p0), "
        "replica_groups={{0,2},{1,3}}, dimensions={0}",
        "%ar = f32[8,16]{1,0} all-reduce(f32[8,16]{1,0} %p1), "
        "to_apply=%add",
        "%rs = f32[4,16]{1,0} reduce-scatter(f32[8,16]{1,0} %p2), "
        "dimensions={0}, to_apply=%add"])
    got = RA.collective_bytes(t.collectives)
    assert got == JRA.collective_bytes(hlo) == \
        {"all-gather": 512, "all-reduce": 512, "reduce-scatter": 256}
    assert t.flops == 0


def test_collective_kinds_by_op_name_equal_repro():
    records = [("_c10d_functional.all_to_all_single.default", 64),
               ("_c10d_functional.all_gather_into_tensor_coalesced.default",
                96),
               ("_c10d_functional.wait_tensor.default", 10**6),
               ("aten.mm.default", 10**6)]
    hlo = "\n".join([
        "%a2a = f32[4,4]{1,0} all-to-all(f32[4,4]{1,0} %p), dimensions={0}",
        "%ag = (f32[4,2]{1,0}, f32[4,4]{1,0}) all-gather-start("
        "f32[2,2]{1,0} %a, f32[2,4]{1,0} %b)",
        "%agd = f32[4,4]{1,0} all-gather-done(%ag)"])
    assert RA.collective_bytes(records) == JRA.collective_bytes(hlo) == \
        {"all-to-all": 64, "all-gather": 96}


def test_per_device_flops_of_a_sharded_chain():
    """The per-device trap: 2,097,152 per device on the 16x16 fake mesh,
    where the global work is 536,870,912."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.utils.flop_counter import FlopCounterMode

    with DR.fake_mesh((16, 16), ("data", "model")) as mesh:
        fm = _fake_mode()
        with fm:
            x = distribute_tensor(torch.empty(64, 1024), mesh,
                                  [Shard(0), Replicate()],
                                  src_data_rank=None)
            w = distribute_tensor(torch.empty(1024, 2048), mesh,
                                  [Replicate(), Shard(1)],
                                  src_data_rank=None)
            w2 = distribute_tensor(torch.empty(2048, 1024), mesh,
                                   [Replicate(), Shard(0)],
                                   src_data_rank=None)
        t = CT.trace(lambda x, w, w2: (x @ w) @ w2, (x, w, w2), fm,
                     mesh=mesh)
        with fm, FlopCounterMode(display=False) as naive:
            (x @ w) @ w2
    assert t.flops == 2 * 1048576 == 2097152
    assert [(d.op, d.lhs, d.rhs, d.out) for d in t.dots] == [
        ("mm", ("f32", (4, 1024)), ("f32", (1024, 128)), (4, 128)),
        ("mm", ("f32", (4, 128)), ("f32", (128, 1024)), (4, 1024))]
    assert naive.get_total_flops() > t.flops * 100


def test_bytes_and_flops_of_one_local_mm():
    fm = _fake_mode()
    m, k, n = 48, 80, 112
    with fm:
        a = torch.empty(m, k, dtype=torch.bfloat16)
        b = torch.empty(k, n, dtype=torch.bfloat16)
    t = CT.trace(torch.mm, (a, b), fm)
    assert len(t.dots) == 1 and t.flops == 2 * m * n * k
    assert t.bytes_accessed == (m * k + k * n + m * n) * 2
    assert (t.argument_bytes, t.output_bytes, t.temp_bytes) == \
        ((m * k + k * n) * 2, m * n * 2, m * n * 2)
    assert HF.dot_flops(t.dots) == [
        (2 * m * n * k, f"bf16[{m},{k}] x bf16[{k},{n}] -> [{m},{n}]", 1)]


def _ref_hlo(arch, shape):
    jcfg = jreduced(JARCHS[arch])
    # Auto axes: ``repro``'s ``shard`` constrains with
    # ``with_sharding_constraint``, which this jax allows on those only
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    cell = j_build_cell(jcfg, JShape(shape.name, shape.seq_len,
                                     shape.global_batch, shape.kind),
                        mesh, analysis_unroll=True)
    P = jax.sharding.PartitionSpec

    def sh(tree):
        return jax.tree_util.tree_map(lambda s: jax.NamedSharding(mesh, s),
                                      tree,
                                      is_leaf=lambda x: isinstance(x, P))
    with j_axis_rules(cell.rules, mesh):
        return jax.jit(cell.fn, in_shardings=sh(cell.in_specs),
                       out_shardings=sh(cell.out_specs),
                       donate_argnums=cell.donate).lower(
                           *cell.args).compile().as_text()


_DEF = re.compile(r"^\s*(?:ROOT\s+)?(%[\w.\-]+)\s*=\s*(\w+\[[\d,]*\])")
_DOT = re.compile(r"\bdot\((%[\w.\-]+),\s*(%[\w.\-]+)\)")


def _inline_operand_shapes(hlo):
    """``dot(%a, %b)`` -> ``dot(f32[..] %a, f32[..] %b)``: this XLA no
    longer prints a dot's operand shapes inline, which ``repro``'s parser
    reads (given the text as it is, it finds no dot at all)."""
    shapes = {}
    for line in hlo.splitlines():
        m = _DEF.match(line)
        if m:
            shapes[m.group(1)] = m.group(2)
    return _DOT.sub(lambda m: f"dot({shapes[m.group(1)]} {m.group(1)}, "
                    f"{shapes[m.group(2)]} {m.group(2)})", hlo)


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_dot_flops_equal_repro_compiled_hlo(kind):
    """Every dot of the step counted as XLA compiles it (M = 1 decode
    dots are left to the analytic checks: XLA:CPU may rewrite them).
    Prefill agrees exactly.  ``repro``'s train step has dots the port's
    has not, and they are dropped by their names: its per-layer
    ``jax.checkpoint`` recomputes the forward inside the backward
    (``rematted_computation``), and its loss takes the target logit with
    a one-hot contraction (``bsv,bsv->bs``, 2*B*S*V) where the port
    gathers it."""
    shape = ShapeConfig(f"{kind}_s", 32, 2, kind)
    with DR.fake_mesh((1, 1), ("data", "model")) as mesh:
        t = DR.trace_cell(build_cell(reduced(ARCHS["tinyllama-1.1b"]),
                                     shape, mesh), mesh)
    hlo = _ref_hlo("tinyllama-1.1b", shape)
    assert JHF.dot_flops(hlo) == []
    lines = _inline_operand_shapes(hlo).splitlines()
    extra = [ln for ln in lines if " dot(" in ln and (
        "rematted_computation" in ln or "bsv,bsv->bs" in ln)]
    assert bool(extra) == (kind == "train")
    jrows = JHF.dot_flops("\n".join(ln for ln in lines if ln not in extra))
    rows = HF.dot_flops(t.dots)
    assert sum(r[0] for r in rows) == sum(r[0] for r in jrows) == t.flops
    assert sum(r[2] for r in rows) == sum(r[2] for r in jrows)
    assert HF.summarize(t.dots)["dot_flops"] == float(t.flops)
    assert HF.top_dots(t.dots).splitlines()[0] == \
        f"total dot flops (per device): {t.flops:.4g}"


def _fixtures(root):
    rows = {
        "single_pod_16x16": [
            ("tinyllama-1.1b", "train_4k", "memory", 0.73),
            ("mistral-nemo-12b", "decode_32k", "collective", 0.41),
            ("olmoe-1b-7b", "prefill_32k", "compute", 0.12)],
        "multi_pod_2x16x16": [
            ("minicpm-2b", "long_500k", None, None)],
    }
    for mesh, cells in rows.items():
        n = 256 if mesh.startswith("single") else 512
        os.makedirs(root / mesh)
        for i, (arch, shape, dom, useful) in enumerate(cells):
            comp = {"mode": "compile", "arch": arch, "shape": shape,
                    "mesh": mesh, "n_devices": n, "compile_s": 12.5 + i,
                    "memory_analysis": {"temp_bytes": 3.2e9 * (i + 1)}
                    if i != 1 else None}
            (root / mesh / f"{arch}__{shape}.compile.json").write_text(
                json.dumps(comp))
            if dom is not None:
                roof = {"mode": "roofline", "arch": arch, "shape": shape,
                        "roofline": {"t_compute": 0.0123 * (i + 1),
                                     "t_memory": 0.5 / (i + 1),
                                     "t_collective": 0.25, "dominant": dom},
                        "useful_flop_ratio": useful}
                (root / mesh / f"{arch}__{shape}.roofline.json").write_text(
                    json.dumps(roof))


def test_report_renders_what_repro_renders(tmp_path, capsys):
    _fixtures(tmp_path)
    REP.render(str(tmp_path))
    got = capsys.readouterr().out
    JREP.render(str(tmp_path))
    want = capsys.readouterr().out
    assert got == want and "| mistral-nemo-12b | decode_32k |" in got


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory):
    import torch_dist_workers as W
    import torch_dryrun_workers as DW
    return W.run_ranks(DW.sharded_cell_ranks, 4,
                       tmp_path_factory.mktemp("cells"))


#: bf16 activations: a split reduction rounds its partial sums apart, so
#: placed and plain runs differ by bf16's rounding compounded over the
#: layers and the backward (at most 0.03 of a leaf's max seen here); a
#: lost or doubled partial sum, a wrong head's KV or a missing gather is
#: off by the order of the values themselves (every rank slicing KV head
#: 0 gives 1.1-2.1).
TOL = 2.0 ** -4


@pytest.mark.parametrize("case", list(range(3)))
def test_placed_cells_compute_the_plain_values_on_four_ranks(
        sharded_runs, case):
    """What the dry run traces computes the step's values: reduced
    TinyLlama's cells (``torch_dryrun_workers.CASES``: prefill on a (2, 2)
    mesh, decode and train on (1, 4)), their arguments placed
    by the cell's specs on four ``gloo`` ranks, against the same cell run
    plain, on every rank."""
    import torch_dryrun_workers as DW

    key = DW.CASES[case]
    for rank, out in enumerate(sharded_runs):
        want, got = out[key]
        assert len(want) == len(got) > 0
        assert DW.max_rel(want, got) <= TOL, (rank, key)


def test_spmd_rules_leave_the_model_code_as_they_found_it():
    from repro_torch.grad import vjp
    from repro_torch.models.lm import common, griffin, rwkv6
    from repro_torch.roofline import partition as PT

    mods = (common, griffin, rwkv6)
    before = [vars(m)["linear"] for m in mods] + \
        [vars(common)[n] for n in PT._ATTENTION] + \
        [vars(vjp._Gemm)["backward"]]
    with PT.spmd():
        inside = [vars(m)["linear"] for m in mods] + \
            [vars(common)[n] for n in PT._ATTENTION]
        x = torch.ones(2, 6)
        assert x.reshape(2, 2, 3) is not None     # plain tensors pass
    after = [vars(m)["linear"] for m in mods] + \
        [vars(common)[n] for n in PT._ATTENTION] + \
        [vars(vjp._Gemm)["backward"]]
    assert all(a is not b for a, b in zip(inside, before))
    assert all(a is b for a, b in zip(after, before))
    assert isinstance(vars(vjp._Gemm)["backward"], staticmethod)


def test_attention_refuses_head_shards_that_straddle_kv_groups():
    """H = 6 query heads over 3 shards (2 a shard) and Hk = 2 KV heads
    (groups of 3): a shard's heads straddle two groups unevenly."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.roofline import partition as PT

    with DR.fake_mesh((1, 3), ("data", "model")) as mesh:
        fm = _fake_mode()
        with fm:
            q = distribute_tensor(torch.empty(2, 4, 6, 8), mesh,
                                  [Replicate(), Shard(2)],
                                  src_data_rank=None)
            k = distribute_tensor(torch.empty(2, 4, 2, 8), mesh,
                                  [Replicate(), Replicate()],
                                  src_data_rank=None)
            with pytest.raises(NotImplementedError, match="straddle"):
                PT.attention_local(lambda *a: a[0], q, k, k)
