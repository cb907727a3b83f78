"""``repro_torch.dist.specs`` against ``repro.dist.specs`` on the CPU.

``param_specs`` and ``cache_specs`` give ``repro``'s ``PartitionSpec``
trees, leaf by leaf (a spec as the tuple of its entries), for every
registered architecture at its published shapes, on the 1x1, 16x16 and
2x16x16 production meshes; and for the prequantized ``{"m", "s"}`` trees
at ``reduced()``.  No full-width parameter is made on either side: the
port's trees are meta tensors (``init_params`` traced under
``FakeTensorMode``, ``init_cache(device="meta")``), the reference's
``jax.eval_shape`` structs read against a stand-in mesh (the specs read
only its axis names and shape).  The port's meshes are ``DeviceMesh``es
over ``"fake"`` process groups of 1, 256 and 512 ranks, each destroyed
once its mesh is built.
"""
import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.configs.base import reduced as jreduced
from repro.configs.registry import ARCHS as JARCHS
from repro.core.bfp import Scheme as JScheme
from repro.core.policy import BFPPolicy as JPolicy
from repro.dist import specs as jspecs
from repro.engine import prequantize as jprequantize
from repro.models.lm import model as JM
from repro_torch import _tree
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import ARCHS
from repro_torch.core.bfp import Scheme
from repro_torch.core.policy import BFPPolicy
from repro_torch.dist import specs
from repro_torch.engine import prequantize
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models.lm import model as M

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
CACHE = (8, 4096)              # decode slots, max length


@pytest.fixture(scope="module")
def meshes():
    """{name: (the port's DeviceMesh, the reference's stand-in mesh)}."""
    assert not dist.is_initialized()
    out = {}
    for name, (shape, axes) in MESHES.items():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=int(np.prod(shape)))
        try:
            if name == "1x1":
                mesh = make_mesh(shape, axes, device_type="cpu")
            else:
                mesh = make_production_mesh(multi_pod=len(shape) == 3,
                                            device_type="cpu")
        finally:
            dist.destroy_process_group()
        out[name] = (mesh, types.SimpleNamespace(
            axis_names=axes, devices=np.empty(shape)))
    return out


def _meta(tree):
    return _tree.tree_map(
        lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta")
        if isinstance(t, torch.Tensor) else t, tree)


def _port(tree):
    return [(_tree.keystr(p), s) for p, s in _tree.leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, tuple))]


def _ref(tree):
    P = jax.sharding.PartitionSpec
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return [(jax.tree_util.keystr(p), tuple(s)) for p, s in flat]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_specs_equal_repro_at_published_shapes(arch, meshes):
    cfg, jcfg = ARCHS[arch], JARCHS[arch]
    with FakeTensorMode():
        fake = M.init_params(cfg, torch.Generator(), device="cpu")
    params = _meta(fake)
    jparams = jax.eval_shape(lambda: JM.init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    cache = M.init_cache(cfg, *CACHE, device="meta")
    jcache = jax.eval_shape(lambda: JM.init_cache(jcfg, *CACHE))
    # the shapes agree leaf by leaf, so the specs are read off one layout
    assert [(p, tuple(t.shape)) for p, t in _port_leaves(params)] == \
        [(p, tuple(t.shape)) for p, t in _ref_leaves(jparams)]
    for name, (mesh, jmesh) in meshes.items():
        got = _port(specs.param_specs(cfg, params, mesh))
        assert got == _ref(jspecs.param_specs(jcfg, jparams, jmesh)), name
        assert len(got) == len(_port_leaves(params))
        assert _port(specs.cache_specs(cfg, cache, mesh)) == \
            _ref(jspecs.cache_specs(jcfg, jcache, jmesh)), name
    if cfg.is_encdec:              # the encoder output once prefilled
        cache = dict(cache, enc_out=torch.empty(
            (CACHE[0], 1024, cfg.d_model), device="meta"))
        jcache = dict(jcache, enc_out=jax.ShapeDtypeStruct(
            (CACHE[0], 1024, jcfg.d_model), np.float32))
        for mesh, jmesh in meshes.values():
            assert _port(specs.cache_specs(cfg, cache, mesh)) == \
                _ref(jspecs.cache_specs(jcfg, jcache, jmesh))


def _port_leaves(tree):
    return [(_tree.keystr(p), t) for p, t in _tree.leaves_with_path(tree)]


def _ref_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(p), t) for p, t in flat]


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "olmoe-1b-7b",
                                  "rwkv6-3b", "recurrentgemma-9b",
                                  "seamless-m4t-medium"])
def test_prequant_sidecar_specs_equal_repro(arch, meshes):
    cfg, jcfg = reduced(ARCHS[arch]), jreduced(JARCHS[arch])
    pol = BFPPolicy(scheme=Scheme.TILED, block_k=32)
    jpol = JPolicy(scheme=JScheme.TILED, block_k=32)
    params = prequantize(M.init_params(cfg, torch.Generator().manual_seed(0),
                                       device="cpu"), pol)
    jparams = jax.eval_shape(lambda: jprequantize(
        JM.init_params(jcfg, jax.random.PRNGKey(0)), jpol))
    assert any(p.endswith("['s']") for p, _ in _port_leaves(params))
    for name, (mesh, jmesh) in meshes.items():
        assert _port(specs.param_specs(cfg, params, mesh)) == \
            _ref(jspecs.param_specs(jcfg, jparams, jmesh)), name
