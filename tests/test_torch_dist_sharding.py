"""``repro_torch.dist.sharding`` and ``repro_torch.launch.mesh`` against
``repro.dist.sharding`` on the CPU, in one process.

``resolve_spec`` gives ``repro``'s tuple, its ``ShardingRuleDropped``
warnings (messages and once-per-(name, axis, size, dim) keys) on a grid
of rules, mesh sizes and shapes; ``tests/test_dist.py``'s identity and
warn-once cases hold in both packages.  Inside a binding the port's
``shard`` redistributes a ``DTensor`` and hands a plain tensor back
unchanged (eager torch has no SPMD partitioner: a difference kept from
the reference, whose ``with_sharding_constraint`` annotates the plain
array).  Meshes are built over a one-rank ``gloo`` group that
``make_mesh`` starts from an in-process store; every test destroys the
group it made, so no pytest worker keeps one.
"""
import warnings

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from repro.dist import sharding as jsharding
from repro_torch.dist import sharding
from repro_torch.launch.mesh import make_mesh

RULES = (
    sharding.DEFAULT_RULES,
    {"batch": ("pod", "data"), "ffn": "model", "experts": ("data", "model"),
     "heads": None},
    {"batch": ["data", "model"], "vocab": "pod", "seq": "data"},
)
SIZES = (
    {"data": 1, "model": 1},
    {"data": 2, "model": 4},
    {"data": 16, "model": 16},
    {"pod": 2, "data": 16, "model": 16},
    {"pod": 4, "data": 2, "model": 1},
)
CASES = (
    ((8, 64, 32), ("batch", "seq", "ffn")),
    ((6, 7), ("batch", "ffn")),
    ((1001, 3), ("batch", "vocab")),
    ((32, 16, 8, 4), ("experts", None, "heads", "nope")),
    ((512, 48), ("batch", "embed")),
    ((9,), ("experts",)),
)


@pytest.fixture
def mesh11():
    assert not dist.is_initialized()
    mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
    yield mesh
    dist.destroy_process_group()


def _drops(rec):
    return [str(r.message) for r in rec
            if issubclass(r.category, (sharding.ShardingRuleDropped,
                                       jsharding.ShardingRuleDropped))]


@pytest.mark.parametrize("rules", range(len(RULES)))
@pytest.mark.parametrize("sizes", range(len(SIZES)))
def test_resolve_spec_equals_repro(rules, sizes):
    rules, sizes = RULES[rules], SIZES[sizes]
    sharding._DROP_WARNED.clear()
    jsharding._DROP_WARNED.clear()
    for shape, names in CASES * 2:           # the second pass warns no more
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            got = sharding.resolve_spec(rules, sizes, shape, names)
        with warnings.catch_warnings(record=True) as jrec:
            warnings.simplefilter("always")
            want = jsharding.resolve_spec(rules, sizes, shape, names)
        assert got == tuple(want), (shape, names)
        assert _drops(rec) == _drops(jrec), (shape, names)
    assert sharding._DROP_WARNED == jsharding._DROP_WARNED


def test_shard_identity_without_context():
    x = torch.randn(4, 8, 16)
    assert sharding.current_rules() is None
    assert sharding.shard(x, "batch", "seq", "embed") is x
    jx = jax.numpy.asarray(x.numpy())
    np.testing.assert_array_equal(
        np.asarray(jsharding.shard(jx, "batch", "seq", "embed")), x.numpy())


def test_indivisible_rule_warns_once_per_rule():
    """``tests/test_dist.py``'s case, run in both packages: the same
    drops, warned once per rule geometry, and the same specs."""
    sizes = {"data": 4, "model": 2}
    rules = {"batch": "data", "ffn": "model", "experts": ("data", "model")}
    calls = (((6, 7), ("batch", "ffn")), ((6, 7), ("batch", "ffn")),
             ((9,), ("experts",)), ((1001,), ("batch",)),
             ((8, 4), ("batch", "ffn")), ((5, 5), ("nope", None)))
    out = {}
    for mod in (sharding, jsharding):
        mod._DROP_WARNED.clear()
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            specs = [mod.resolve_spec(rules, sizes, s, n) for s, n in calls]
        out[mod] = ([tuple(p) for p in specs], _drops(rec))
    assert out[sharding] == out[jsharding]
    specs, drops = out[sharding]
    assert specs[:3] == [(None, None), (None, None), (None,)]
    assert specs[4:] == [("data", "model"), (None, None)]
    assert len(drops) == 4                   # 3 rules + 1 new geometry
    assert any("batch" in d and "'data'" in d for d in drops)


def test_shard_inside_binding(mesh11):
    x = torch.randn(4, 16)
    with sharding.axis_rules(sharding.DEFAULT_RULES, mesh11):
        assert sharding.current_rules()[1] is mesh11
        # a plain tensor: resolved, handed back unchanged (kept difference)
        assert sharding.shard(x, "batch", "ffn") is x
        assert sharding.shard(x, "batch") is x         # ndim mismatch
        d = distribute_tensor(x, mesh11, [Replicate(), Replicate()])
        y = sharding.shard(d, "batch", "ffn")
        z = sharding.shard(d, None, "nope")
        with sharding.axis_rules({"batch": None}, mesh11):
            assert sharding.current_rules()[0] == {"batch": None}
        assert sharding.current_rules()[1] is mesh11   # restored
    assert sharding.current_rules() is None
    assert isinstance(y, DTensor)
    assert tuple(y.placements) == (Shard(0), Shard(1))
    assert tuple(z.placements) == (Replicate(), Replicate())
    assert torch.equal(y.full_tensor(), x)
    assert sharding.mesh_axis_sizes(mesh11) == {"data": 1, "model": 1}


def test_placements_follow_mesh_order(mesh11):
    pl = sharding.placements(mesh11, (("data", "model"), None))
    assert pl == [Shard(0), Shard(0)]
    assert sharding.placements(mesh11, (None, "model", None)) == \
        [Replicate(), Shard(1)]
    with pytest.raises(ValueError, match="mesh order"):
        sharding.placements(mesh11, (("model", "data"),))
    with pytest.raises(ValueError, match="shards two"):
        sharding.placements(mesh11, ("data", "data"))


def test_make_mesh_checks_the_group():
    assert not dist.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh((1, 1), ("data", "model"))
    with pytest.raises(ValueError, match="has 4 devices but no process "
                                         "group"):
        make_mesh((2, 2), ("data", "model"), device_type="cpu")
    with pytest.raises(ValueError, match="differ in length"):
        make_mesh((1,), ("data", "model"), device_type="cpu")
    assert not dist.is_initialized()
    mesh = make_mesh((1,), ("data",), device_type="cpu")
    try:
        assert dist.get_world_size() == 1 and mesh.shape == (1,)
        with pytest.raises(ValueError, match="has 2 devices but the process "
                                             "group's world size is 1"):
            make_mesh((2, 1), ("data", "model"), device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_group_amax_and_any_rank_outside_a_split(mesh11):
    a = torch.tensor([[3.0]])
    assert sharding.group_amax(a) is a             # no batch_group
    groups = [mesh11.get_group(0)]
    with sharding.batch_group(groups):
        assert torch.equal(sharding.group_amax(a), a)   # one-rank group
    assert not sharding.any_rank(False, groups, torch.device("cpu"))
    assert sharding.any_rank(True, groups, torch.device("cpu"))


def test_default_rules_and_names_equal_repro():
    assert sharding.DEFAULT_RULES == jsharding.DEFAULT_RULES
    assert set(jsharding.__all__) <= set(sharding.__all__)
