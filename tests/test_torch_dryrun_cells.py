"""The dry-run cells that need ``roofline.partition``'s rules beyond
attention, on meshes of more than one device (``repro`` traces every
(arch x shape) cell on its meshes; the port traces these since the MoE
dispatch, the RG-LRU scan, the WKV core and head counts the model axis
does not divide got their rules).

Each case of ``torch_dryrun_workers.CELL_CASES`` is a ``reduced()``
config that recreates one full-width failure on a (1, 4) mesh:

* MoE expert-parallel (4 experts on the model axis) and tensor-parallel
  inside experts (2 experts), prefill and train, at a capacity factor
  where tokens drop;
* the hybrid at one (rec, rec, attn) period, prefill and train;
* training with 6 attention heads and with 6 WKV heads on 4.

Each traces on a fake mesh through ``launch.dryrun.trace_cell`` and,
placed by the cell's specs on 4 spawned ``gloo`` ranks under ``spmd()``,
computes what the plain run computes.  The MoE dispatch is global over
the tokens, as on one device: the placed run drops exactly the plain
run's tokens, where a per-shard capacity would drop others.  The float
GEMM (the MoE router's) promotes a bf16 x and an f32 weight as ``repro``'s
``jnp`` matmul does (F13).

Every test that starts a fake process group destroys it.
"""
import numpy as np
import pytest
import torch

import torch_dryrun_workers as DW
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as DR
from repro_torch.launch.input_specs import build_cell

#: f32 steps (``torch_dryrun_workers.f32_fn``): split and whole reductions
#: agree to 1e-5 of a leaf's largest here; a lost or doubled partial sum,
#: a wrong expert's slots or a missing gather is off by the values' order.
TOL_F32 = 1e-4


#: the spawned ranks' time limit: they run while this process traces
RANKS_S = 300


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The 4 ranks' run, started at once in a thread: the fake-mesh
    traces below run in this process meanwhile."""
    import concurrent.futures

    import torch_dist_workers as W
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield pool.submit(W.run_ranks, DW.cell_ranks, 4,
                          tmp_path_factory.mktemp("cells"), join_s=RANKS_S)


@pytest.fixture(scope="module")
def cell_runs(spawned):
    return spawned.result()


@pytest.mark.parametrize("case", DW.CELL_CASES, ids=lambda c: "-".join(
    map(str, c)))
def test_cell_traces_on_a_fake_mesh(spawned, case):
    """Traced per device on the fake (1, 4) mesh: something is split
    (fewer FLOPs than the one-device trace) and nothing beyond the
    four-way split."""
    name, shape, kind = case
    cfg = DW.cell_config(name)
    sh = ShapeConfig(kind, 32, 4, kind)
    with DR.fake_mesh(shape, ("data", "model")) as mesh:
        placed = DR.trace_cell(build_cell(cfg, sh, mesh), mesh)
    with DR.fake_mesh((1, 1), ("data", "model")) as mesh1:
        one = DR.trace_cell(build_cell(cfg, sh, mesh1), mesh1)
    assert one.flops / 4 <= placed.flops < one.flops, (placed.flops,
                                                       one.flops)
    if kind == "train" or name.startswith(("olmoe", "mixtral")):
        assert placed.collectives


@pytest.mark.parametrize("case", DW.CELL_CASES, ids=lambda c: "-".join(
    map(str, c)))
def test_placed_cells_compute_the_plain_values(cell_runs, case):
    for rank, out in enumerate(cell_runs):
        want, got, _, _ = out[case]
        assert len(want) == len(got) > 0
        assert DW.max_rel(want, got) <= TOL_F32, (rank, case)


def _keep_by_item(expert_ids, e, cap):
    """``moe._route``'s keep mask in (token, k) order."""
    from repro_torch.models.lm import moe

    keep = moe._route(expert_ids, torch.ones(expert_ids.shape), e, cap)[2]
    out = torch.empty_like(keep)
    out[torch.argsort(expert_ids.reshape(-1), stable=True)] = keep
    return out


@pytest.mark.parametrize("case", [c for c in DW.CELL_CASES
                                  if c[0] in ("olmoe_ep", "mixtral_tp")],
                         ids=lambda c: "-".join(map(str, c)))
def test_moe_dispatch_is_global_over_tokens(cell_runs, case):
    """Every rank routes the plain run's experts and drops exactly its
    tokens (some drop); a capacity per row shard would keep others."""
    for out in cell_runs:
        _, _, plain, placed = out[case]
        assert len(plain) == len(placed) > 0
        for (ids, gates, keep, e, cap), (pids, pgates, pkeep, _, _) in zip(
                plain, placed):
            assert torch.equal(ids, pids)
            assert torch.equal(keep, pkeep) and not bool(keep.all())
            np.testing.assert_allclose(pgates.numpy(), gates.numpy(),
                                       rtol=1e-5, atol=1e-6)
            k = ids.shape[1]
            per_shard = torch.cat([
                _keep_by_item(rows, e, int(rows.shape[0] * k / e
                                           * DW.MOE_CF + 1))
                for rows in ids.chunk(4)])
            assert not torch.equal(_keep_by_item(ids, e, cap), per_shard)


def test_spmd_rules_restore_the_moe_and_wkv_code():
    from repro_torch.models.lm import moe, rwkv6
    from repro_torch.roofline import partition as PT

    names = [(moe, "_route"), (moe, "_experts"), (rwkv6, "_wkv_chunked")]
    before = [vars(m)[n] for m, n in names]
    with PT.spmd():
        inside = [vars(m)[n] for m, n in names]
        x = torch.ones(2, 3, 4)
        assert torch.equal(moe._route(torch.zeros(2, 1, dtype=torch.long),
                                      torch.ones(2, 1), 2, 2)[2],
                           torch.ones(2, dtype=torch.bool))
        assert x.reshape(6, 4).shape == (6, 4)     # plain tensors pass
    after = [vars(m)[n] for m, n in names]
    assert all(a is not b for a, b in zip(inside, before))
    assert all(a is b for a, b in zip(after, before))


def test_wkv_core_runs_on_its_shard():
    """RWKV6's WKV core under ``spmd()`` on a fake (2, 2) mesh, rows on
    "data" and heads on "model": a quarter of the one-device FLOPs and no
    collective (DTensor's own einsum strategies moved data here: this
    rule moved the WKV cells' bytes and collectives, not their FLOPs)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models.lm import rwkv6
    from repro_torch.roofline import counter as CT
    from repro_torch.roofline import partition as PT

    def core(r, k, v, w, u):
        return rwkv6._wkv_chunked(r, k, v, w, u)

    shapes = [(4, 64, 4, 16)] * 4 + [(4, 16)]
    fm = FakeTensorMode(allow_non_fake_inputs=True)
    with fm:
        plain = [torch.empty(sh) for sh in shapes]
    one = CT.trace(core, plain, fm)
    with DR.fake_mesh((2, 2), ("data", "model")) as mesh:
        fm = FakeTensorMode(allow_non_fake_inputs=True)
        with fm:
            args = [distribute_tensor(torch.empty(sh), mesh,
                                      [Shard(0), Shard(2)],
                                      src_data_rank=None)
                    for sh in shapes[:4]]
            args.append(distribute_tensor(torch.empty(shapes[4]), mesh,
                                          [Replicate(), Shard(0)],
                                          src_data_rank=None))
        with PT.spmd():
            t = CT.trace(core, args, fm, mesh=mesh, rules={"batch": "data"})
    assert one.flops > 0 and t.flops * 4 == one.flops
    assert not t.collectives


def test_float_gemm_promotes_mixed_dtypes_as_repro():
    """F13: a bf16 x against an f32 weight (the MoE router at a bf16
    compute dtype) computes in f32, as ``jnp``'s matmul promotes; the
    port's float GEMM raised on the mixed dtypes."""
    import jax.numpy as jnp

    from repro import engine as JEG
    from repro_torch import engine as EG

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((16, 64), np.float32)).to(
        torch.bfloat16)
    w = rng.standard_normal((64, 8), np.float32)
    got = EG.gemm(x, torch.from_numpy(w), None)
    want = np.asarray(JEG.gemm(jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16), jnp.asarray(w), None))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
