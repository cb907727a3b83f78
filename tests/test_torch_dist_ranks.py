"""Data-parallel CNN serving, ``shard`` on ``DTensor``s and
``restore(sharding_fn=)`` across spawned ``gloo`` ranks on the CPU
(``tests/torch_dist_workers.py`` holds the rank bodies).

Two ranks, one spawn: reduced LeNet and CIFARNet served on a (2, 1)
mesh (3 requests padded to bucket 4, each rank running its 2 rows) give
logits bit-equal to the single-process unsharded engine at EQ4 (the
emulated datapath, whose whole-matrix activation block takes its max
over the data group) and at ``PALLAS_TILED`` (the kernels' plain
versions); a bucket of 3 drops the rule with one ``ShardingRuleDropped``
and runs the whole batch; a (1, 2) mesh runs it replicated.  The control:
with the group max switched off, EQ4's logits differ.  A forward that
raises on one rank fails the group on both, and neither waits in the
gather.  Four ranks, one spawn: ``shard`` of a replicated ``DTensor`` on
a (2, 2) mesh gives each rank the block JAX's layout gives its mesh
coordinates (``P("data", "model")``; ``P(("data", "model"))`` major to
minor), and checkpoints restored onto the mesh gather back to the
unsharded restore.  Each spawn takes ~10-20 s; every rank is joined
within ``torch_dist_workers.JOIN_S``.
"""
import numpy as np
import pytest
import torch

import torch_dist_workers as W
from repro_torch import _tree
from repro_torch.checkpoint import store
from repro_torch.core.policy import TPU_TILED
from repro_torch.models.cnn import MODELS

CASES = [(m, p) for m in ("lenet", "cifarnet") for p in ("eq4", "tiled")]


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return W.run_ranks(W.engine_ranks, 2, tmp_path_factory.mktemp("two"))


@pytest.fixture(scope="module")
def unsharded():
    return {c: W.serve(*c) for c in CASES}


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("ckpt")
    like = MODELS["lenet"].init(torch.Generator().manual_seed(0),
                                reduced=True, device="cpu")
    store.save(str(ckpt / "float"), 0, like)
    store.save(str(ckpt / "dequant"), 0, like, format="bfp_packed",
               policy=TPU_TILED.with_(block_k=None, straight_through=False))
    return W.run_ranks(W.mesh22_ranks, 4, tmp_path_factory.mktemp("four"),
                       str(ckpt))


@pytest.mark.parametrize("model,pol", CASES)
def test_split_batch_bit_equal_to_unsharded(two, unsharded, model, pol):
    want, errs, drops = unsharded[model, pol]
    assert errs == [None] * 3 and drops == 0
    assert want.shape == (3, 10) and np.isfinite(want).all()
    for rank, out in enumerate(two):
        got, errs, drops = out[model, pol, "2x1"]
        assert errs == [None] * 3 and drops == 0, rank
        assert np.array_equal(got, want), (rank, np.abs(got - want).max())


@pytest.mark.parametrize("model,pol", CASES)
def test_dropped_rule_runs_the_whole_batch(two, unsharded, model, pol):
    want = unsharded[model, pol][0]
    for out in two:
        got, errs, drops = out[model, pol, "2x1_b3"]
        assert errs == [None] * 3 and drops == 1
        assert np.array_equal(got, want)


@pytest.mark.parametrize("model,pol", CASES)
def test_model_axis_mesh_runs_replicated(two, unsharded, model, pol):
    want = unsharded[model, pol][0]
    for out in two:
        got, errs, drops = out[model, pol, "1x2"]
        assert errs == [None] * 3 and drops == 0
        assert np.array_equal(got, want)


def test_eq4_without_the_group_max_differs(two, unsharded):
    want = unsharded["lenet", "eq4"][0]
    got = [out["lenet", "eq4", "2x1_local_max"][0] for out in two]
    assert all(g is not None for g in got)
    assert not all(np.array_equal(g, want) for g in got)


def test_forward_raising_on_one_rank_fails_the_group(two):
    for out in two:
        logits, errs, _ = out["lenet", "tiled", "2x1_raises"]
        assert logits is None and all(e is not None for e in errs)
    assert "rank 1" in two[1]["lenet", "tiled", "2x1_raises"][1][0]
    assert "another rank" in two[0]["lenet", "tiled", "2x1_raises"][1][0]


def test_shard_gives_jax_layout_blocks(four):
    x = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    coords = sorted(out["coord"] for out in four)
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for out in four:
        i, j = out["coord"]
        local, full, place = out["batch_ffn"]     # P("data", "model")
        assert place == ("S(0)", "S(1)")
        assert torch.equal(local, x[4 * i:4 * i + 4, 6 * j:6 * j + 6])
        assert torch.equal(full, x)
        local, full, place = out["tuple"]         # P(("data", "model"))
        k = 2 * i + j
        assert place == ("S(0)", "S(0)")
        assert torch.equal(local, x[2 * k:2 * k + 2])
        assert torch.equal(full, x)


@pytest.mark.parametrize("mode", ["float", "dequant"])
def test_restore_onto_a_mesh_gathers_back(four, mode):
    for out in four:
        rows = out[mode]
        assert rows and all(eq for _, eq in rows)
    # dim 0 split over "data": each rank holds about half of a leaf
    like = MODELS["lenet"].init(torch.Generator().manual_seed(0),
                                reduced=True, device="cpu")
    full = [tuple(t.shape) for t in _tree.flatten(like)[0]]
    for (shape, _), want in zip(four[0][mode], full):
        if want and want[0] > 1:
            assert shape[0] == -(-want[0] // 2) and shape[1:] == want[1:]
