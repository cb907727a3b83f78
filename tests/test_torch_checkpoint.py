"""``repro_torch.checkpoint.store`` against ``repro.checkpoint.store``.

One reduced ResNet-18 (Python ints and a bool in ``meta``, BN statistics
from a seed), saved by each package in each format (``float32``,
``bfp_packed``, ``bfp_packed_v2``): ``arrays.npz`` is byte-identical and
the manifests are equal but for ``treedef``; each artifact restores in
the other package in every ``packed=`` mode, the sidecars ``torch.equal``
to the port's own ``bind`` prequantization, and the restored tree
serves.  Then the store's own machinery on the port: a corrupt latest
step is skipped with the warning, an explicit corrupt step raises
``IntegrityError``, shape and tree mismatches, ``keep`` GC, the async
checkpointer with packed trees, and the refusal of a packed save that
packs nothing.
"""
import json
import os
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.core.policy import TPU_TILED as J_TPU_TILED
from repro_torch import _tree
from repro_torch import engine as EG
from repro_torch.checkpoint import store
from repro_torch.convert import params_from_numpy
from repro_torch.core import packed
from repro_torch.core.policy import TPU_TILED
from repro_torch.engine import PolicyMap
from repro_torch.models.cnn import MODELS, small
from repro_torch.serve.degrade import float_params
from test_torch_models_cnn import jax_params, with_bn_from_seed
from test_torch_util import assert_bits_equal, normal, t

POL = TPU_TILED.with_(block_k=None, straight_through=False)
J_POL = J_TPU_TILED.with_(block_k=None, straight_through=False)
FORMATS = ("float32", "bfp_packed", "bfp_packed_v2")
MODES = ("prequant", "dequant", "keep")
STEP = "step_00000007"


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """(numpy params, port tree, {(package, format): base dir})."""
    params = with_bn_from_seed(jax_params("resnet18"),
                               np.random.default_rng(4))
    tp = params_from_numpy(params, "cpu")
    dirs = {}
    root = tmp_path_factory.mktemp("ckpt")
    for fmt in FORMATS:
        kw = {} if fmt == "float32" else {"policy": POL}
        jkw = {} if fmt == "float32" else {"policy": J_POL}
        dirs["port", fmt] = str(root / f"port_{fmt}")
        dirs["repro", fmt] = str(root / f"repro_{fmt}")
        store.save(dirs["port", fmt], 7, tp, format=fmt, **kw)
        jstore.save(dirs["repro", fmt], 7, params, format=fmt, **jkw)
    return params, tp, dirs


def _read(base, name):
    with open(os.path.join(base, STEP, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("fmt", FORMATS)
def test_artifacts_byte_identical_manifest_equal_but_treedef(artifacts,
                                                             fmt):
    _, tp, dirs = artifacts
    a, b = dirs["port", fmt], dirs["repro", fmt]
    assert _read(a, "arrays.npz") == _read(b, "arrays.npz")
    ma, mb = (json.loads(_read(d, "manifest.json")) for d in (a, b))
    assert list(ma) == list(mb)                    # same fields, same order
    ta, tb = ma.pop("treedef"), mb.pop("treedef")
    assert ma == mb
    assert ta == _tree.describe(
        packed.pack_param_tree(tp, POL, variable=fmt == "bfp_packed_v2")
        if fmt != "float32" else tp,
        is_leaf=packed.is_packed)
    assert ma["n_leaves"] == 80 and "'meta': (*, (*, *, *, *), *)" in ta
    assert ma["format"] == fmt
    assert bool(ma["packed_leaves"]) == (fmt != "float32")


def _port_reference(tp, mode, variable):
    """What a port restore must give in ``mode``: the plan's sidecars
    ("prequant"), their dequantization ("dequant"), the port's own
    containers ("keep")."""
    bound = EG.bind(tp, POL, tree="cnn", device="cpu").params
    if mode == "prequant":
        return bound
    if mode == "dequant":
        return float_params(bound, "cpu")
    return packed.pack_param_tree(tp, POL, variable=variable)


def _leaves(tree):
    return _tree.flatten(tree, is_leaf=packed.is_packed)[0]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fmt", FORMATS)
def test_repro_artifact_restores_in_the_port(artifacts, fmt, mode):
    params, tp, dirs = artifacts
    got, step = store.restore(dirs["repro", fmt], tp, packed=mode,
                              device="cpu")
    mine, _ = store.restore(dirs["port", fmt], tp, packed=mode,
                            device="cpu")
    assert step == 7
    want = tp if fmt == "float32" else _port_reference(
        tp, mode, fmt == "bfp_packed_v2")
    assert got["meta"] == (18, (1, 1, 1, 1), False)
    assert type(got["meta"][2]) is bool and type(got["meta"][0]) is int
    a, b, c = _leaves(got), _leaves(mine), _leaves(want)
    assert len(a) == len(b) == len(c)
    for x, y, z in zip(a, b, c):
        if packed.is_packed(x):
            assert x.to_bytes() == y.to_bytes() == z.to_bytes()
        elif isinstance(x, torch.Tensor):
            assert torch.equal(x, y) and torch.equal(x, z)
            assert x.device.type == "cpu"
        else:
            assert x == y == z
    # the restored tree serves: the logits of the bound float tree
    x = t(normal((2, 32, 32, 3), seed=9))
    apply = MODELS["resnet18"].apply
    ref_plan = EG.bind(tp, POL, tree="cnn", device="cpu")
    plan = EG.bind(got, POL, tree="cnn", device="cpu",
                   prequantize=fmt == "float32")
    assert torch.equal(plan.jit_forward(apply)(x),
                       ref_plan.jit_forward(apply)(x))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fmt", FORMATS)
def test_port_artifact_restores_in_repro(artifacts, fmt, mode):
    params, _, dirs = artifacts
    got, step = jstore.restore(dirs["port", fmt], params, packed=mode)
    want, _ = jstore.restore(dirs["repro", fmt], params, packed=mode)
    assert step == 7
    from repro.core.packed import is_packed as j_is_packed
    a = jax.tree_util.tree_leaves(got, is_leaf=j_is_packed)
    b = jax.tree_util.tree_leaves(want, is_leaf=j_is_packed)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if j_is_packed(x):
            assert x.to_bytes() == y.to_bytes()
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# ---------------------------------------------------------------------------
# The store's machinery on the port
# ---------------------------------------------------------------------------

def _lenet(seed=0):
    return MODELS["lenet"].init(torch.Generator().manual_seed(seed),
                                device="cpu")


def _same_tree(a, b):
    for x, y in zip(_leaves(a), _leaves(b)):
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y


def test_corrupt_latest_step_falls_back_with_warning(tmp_path):
    d = str(tmp_path)
    trees = [_lenet(s) for s in range(3)]
    for s, p in enumerate(trees):
        store.save(d, s, p, keep=5, format="bfp_packed" if s == 1
                   else "float32", policy=POL if s == 1 else None)
    apath = os.path.join(d, "step_00000002", "arrays.npz")
    raw = bytearray(open(apath, "rb").read())
    raw[len(raw) // 2] ^= 0x40
    with open(apath, "wb") as f:
        f.write(raw)
    with pytest.warns(store.CheckpointCorruptionWarning):
        assert store.latest_step(d) == 1
    with pytest.warns(store.CheckpointCorruptionWarning):
        tree, s = store.restore(d, trees[0], device="cpu")
    assert s == 1
    _same_tree(tree, EG.bind(trees[1], POL, device="cpu").params)
    with pytest.raises(packed.IntegrityError):
        store.restore(d, trees[0], step=2, device="cpu")
    with pytest.raises(packed.IntegrityError):
        store.restore(d, trees[0], step=9, device="cpu")   # missing step


def test_shape_and_tree_mismatch_raise(tmp_path):
    params = _lenet()
    other = small.lenet_init(torch.Generator().manual_seed(0),
                             num_classes=7, device="cpu")
    store.save(str(tmp_path), 0, params, format="bfp_packed", policy=POL)
    with pytest.raises(ValueError, match="mismatch"):
        store.restore(str(tmp_path), other, device="cpu")
    with pytest.raises(ValueError, match="mismatch"):
        store.restore(str(tmp_path), {"w": params["c1"]["w"]}, device="cpu")
    assert store.restore(str(tmp_path / "none"), params,
                         device="cpu") == (None, None)


def test_keep_gc_and_latest_step(tmp_path):
    d = str(tmp_path)
    params = _lenet()
    for s in range(5):
        store.save(d, s, params, keep=2)
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004"]
    assert store.latest_step(d) == 4


def test_async_checkpointer_handles_packed_trees(tmp_path):
    d = str(tmp_path)
    params = _lenet()
    ck = store.Checkpointer(d, format="bfp_packed", policy=POL)
    ck.save_async(3, params)
    ck.wait()
    got, step = store.restore(d, params, packed="keep", device="cpu")
    assert step == 3 and sum(packed.is_packed(x) for x in _leaves(got)) == 4
    pk = packed.pack_param_tree(params, POL, "cnn")
    ck2 = store.save_async(d, 4, pk)
    ck2.wait()
    got2, step2 = store.restore(d, params, device="cpu")
    assert step2 == 4
    _same_tree(got2, EG.bind(params, POL, device="cpu").params)
    with pytest.raises(ValueError, match="packed zero leaves"):
        ck3 = store.Checkpointer(d, format="bfp_packed")
        ck3.save_async(5, params)
        ck3.wait()


def test_save_and_restore_validation(tmp_path):
    d = str(tmp_path)
    params = _lenet()
    with pytest.raises(ValueError, match="unknown checkpoint format"):
        store.save(d, 0, params, format="int4")
    with pytest.raises(ValueError, match="packed zero leaves"):
        store.save(d, 0, params, format="bfp_packed")
    none_map = PolicyMap.of(("^no_such_layer$", POL), default=None)
    with pytest.raises(ValueError, match="packed zero leaves"):
        store.save(d, 0, params, format="bfp_packed_v2", policy=none_map)
    assert store.latest_step(d) is None            # nothing was written
    store.save(d, 0, params, format="bfp_packed", policy=POL)
    with pytest.raises(ValueError, match="packed"):
        store.restore(d, params, packed="nope", device="cpu")
    # sharding_fn places each plain leaf (tests/test_torch_dist_ranks.py
    # places them on a mesh)
    placed, _ = store.restore(d, params, device="cpu",
                              sharding_fn=lambda i: torch.device("cpu"))
    _same_tree(placed, store.restore(d, params, device="cpu")[0])
    # an LM tree whose only leaf is the embedding (never a GEMM weight)
    with pytest.raises(ValueError, match="packed zero leaves"):
        store.save(d, 1, {"embed": torch.zeros(4, 2)}, format="bfp_packed",
                   policy=POL)
    # a pre-packed tree needs no policy; fixed and variable leaves share
    # one manifest
    pre = packed.pack_param_tree(params, PolicyMap.of(("^c1$", POL),
                                                      default=None))
    store.save(d, 2, pre, format="bfp_packed_v2",
               policy=PolicyMap.of(("^c1$", None), default=POL))
    man = json.loads(open(os.path.join(d, "step_00000002",
                                       "manifest.json")).read())
    dts = [man["dtypes"][i] for i in man["packed_leaves"]]
    assert man["format"] == "bfp_packed_v2"
    assert "bfp_packed8" in dts and "bfp_packed8v" in dts
    got, _ = store.restore(d, params, device="cpu")
    _same_tree(got, EG.bind(params, POL, device="cpu").params)
    # dequant gives the float tree of the original structure
    deq, _ = store.restore(d, params, packed="dequant", device="cpu")
    assert deq["c1"]["w"].dtype == torch.float32
    assert_bits_equal(deq["c1"]["w"], float_params(
        EG.bind(params, POL, device="cpu").params, "cpu")["c1"]["w"]
        .numpy())


def test_restore_places_on_cuda_by_default(tmp_path, monkeypatch):
    store.save(str(tmp_path), 0, _lenet())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        store.restore(str(tmp_path), _lenet())
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tree, _ = store.restore(str(tmp_path), _lenet(), device="cpu")
    assert tree["c1"]["w"].device.type == "cpu"
