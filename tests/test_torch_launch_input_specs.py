"""``repro_torch.launch.input_specs`` against ``repro.launch.input_specs``
on the CPU.

* ``cell_rules`` equal ``repro``'s for every architecture x shape on the
  1x1, 16x16 and 2x16x16 meshes; ``input_specs`` shapes and dtypes;
  ``with_layer_units``, ``layer_units`` and ``pad_heads_for_tp`` on every
  architecture; ``_strip_fsdp`` on ``repro``'s own spec trees.
* ``build_cell`` on ``reduced()`` TinyLlama, OLMoE, RecurrentGemma and
  seamless, train / prefill / decode, on a 1x1 mesh: argument trees
  (paths, shapes, dtypes), spec trees, out specs and ``donate`` equal
  ``repro``'s; every argument leaf is a meta tensor (no storage);
  ``bfp_weights`` gives the ``{"m", "s"}`` leaves.

The port's meshes are ``DeviceMesh``es over ``"fake"`` process groups,
each destroyed once its mesh is built (rules and specs read only names
and sizes).  The reference side reads a stand-in mesh (axis names and a
``devices`` array of the mesh's shape) where it reads only those, and a
one-device ``jax`` mesh for ``build_cell``.
"""
import dataclasses
import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import reduced as jreduced
from repro.configs.registry import ARCHS as JARCHS
from repro.core.policy import BFPPolicy as JPolicy
from repro.dist import specs as jspecs
from repro.launch import input_specs as JI
from repro.models.lm import model as JM
from repro_torch import _tree
from repro_torch.configs.base import SHAPES, ShapeConfig, reduced
from repro_torch.configs.registry import ARCHS
from repro_torch.core.policy import BFPPolicy
from repro_torch.launch import input_specs as I
from repro_torch.launch.mesh import make_mesh

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
P = jax.sharding.PartitionSpec


@pytest.fixture(scope="module")
def meshes():
    """{name: (the port's DeviceMesh, the reference's stand-in mesh)}."""
    assert not dist.is_initialized()
    out = {}
    for name, (shape, axes) in MESHES.items():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=int(np.prod(shape)))
        try:
            mesh = make_mesh(shape, axes, device_type="cpu")
        finally:
            dist.destroy_process_group()
        out[name] = (mesh, types.SimpleNamespace(
            axis_names=axes, devices=np.empty(shape)))
    return out


def _spec(s):
    """A reference spec leaf as the port's tuple."""
    return tuple(s)


def _ref_specs(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return [(jax.tree_util.keystr(p), _spec(s)) for p, s in flat]


def _port_specs(tree):
    return [(_tree.keystr(p), s) for p, s in
            _tree.leaves_with_path(tree, is_leaf=I._is_spec)]


def _ref_args(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(p), tuple(x.shape), str(x.dtype))
            for p, x in flat]


def _port_args(tree):
    return [(_tree.keystr(p), tuple(x.shape), str(x.dtype).split(".")[-1])
            for p, x in _tree.leaves_with_path(tree)]


def test_cell_rules_and_input_specs_equal_repro(meshes):
    n = 0
    for arch in sorted(ARCHS):
        for sname in sorted(SHAPES):
            cfg, shape = ARCHS[arch], SHAPES[sname]
            jcfg, jshape = JARCHS[arch], JSHAPES[sname]
            for name, (mesh, jmesh) in meshes.items():
                assert I.cell_rules(cfg, shape, mesh) == \
                    JI.cell_rules(jcfg, jshape, jmesh), (arch, sname, name)
                n += 1
            got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1],
                       v.device.type)
                   for k, v in I.input_specs(cfg, shape).items()}
            want = {k: (tuple(v.shape), str(v.dtype), "meta")
                    for k, v in JI.input_specs(jcfg, jshape).items()}
            assert got == want, (arch, sname)
    assert n == len(ARCHS) * len(SHAPES) * len(MESHES)


def _fields(cfg):
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_layer_units_and_head_padding_equal_repro(arch):
    cfg, jcfg = ARCHS[arch], JARCHS[arch]
    assert I.layer_units(cfg) == JI.layer_units(jcfg)
    for u in (1, 2, 3):
        assert _fields(I.with_layer_units(cfg, u)) == \
            _fields(JI.with_layer_units(jcfg, u))
    for m in (1, 16, 48):
        assert _fields(I.pad_heads_for_tp(cfg, m)) == \
            _fields(JI.pad_heads_for_tp(jcfg, m))


@pytest.mark.parametrize("mesh_name", ["16x16", "2x16x16"])
def test_strip_fsdp_equal_repro_on_repro_specs(meshes, mesh_name):
    jmesh = meshes[mesh_name][1]
    for arch in sorted(JARCHS):
        jcfg = JARCHS[arch]
        jparams = jax.eval_shape(lambda c=jcfg: JM.init_params(
            c, jax.random.PRNGKey(0)))
        jtree = jspecs.param_specs(jcfg, jparams, jmesh)
        # the port's tree: repro's specs as the port's tuples
        tree = jax.tree_util.tree_map(_spec, jtree,
                                      is_leaf=lambda x: isinstance(x, P))
        got = _port_specs(I._strip_fsdp(tree))
        assert got == _ref_specs(JI._strip_fsdp(jtree)), arch
        assert any(s != w for (_, s), (_, w) in
                   zip(got, _port_specs(tree))), arch


KINDS = {"train": ShapeConfig("train_s", 32, 2, "train"),
         "prefill": ShapeConfig("prefill_s", 32, 2, "prefill"),
         "decode": ShapeConfig("decode_s", 32, 2, "decode")}


def _jshape(shape):
    from repro.configs.base import ShapeConfig as JShape
    return JShape(shape.name, shape.seq_len, shape.global_batch, shape.kind)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "olmoe-1b-7b",
                                  "recurrentgemma-9b",
                                  "seamless-m4t-medium"])
def test_build_cell_equals_repro(meshes, arch):
    mesh = meshes["1x1"][0]
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    cfg, jcfg = reduced(ARCHS[arch]), jreduced(JARCHS[arch])
    for kind, shape in KINDS.items():
        for bfp in ((None,) if kind == "train" else (None, 32)):
            kw = {} if bfp is None else dict(
                bfp_weights=BFPPolicy(l_w=8, l_i=8, block_k=bfp))
            jkw = {} if bfp is None else dict(
                bfp_weights=JPolicy(l_w=8, l_i=8, block_k=bfp))
            cell = I.build_cell(cfg, shape, mesh, **kw)
            jcell = JI.build_cell(jcfg, _jshape(shape), jmesh, **jkw)
            where = (arch, kind, bfp)
            assert cell.arch == jcell.arch and cell.donate == jcell.donate
            assert cell.rules == jcell.rules, where
            assert _port_args(cell.args) == _ref_args(jcell.args), where
            leaves = [x for x in _tree.flatten(cell.args)[0]]
            assert leaves and all(isinstance(x, torch.Tensor)
                                  and x.device.type == "meta"
                                  for x in leaves), where
            assert _port_specs(cell.in_specs) == \
                _ref_specs(jcell.in_specs), where
            assert _port_specs(cell.out_specs) == \
                _ref_specs(jcell.out_specs), where
            quantized = [p for p, _, _ in _port_args(cell.args[0])
                         if p.endswith("['m']") or p.endswith("['s']")]
            assert bool(quantized) == (bfp is not None), where
