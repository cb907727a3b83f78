"""Port parity for the slice's models: reduced ResNet-18, ResNet-50 and
GoogLeNet (and the two small CNNs) of ``repro_torch.models.cnn`` against
``repro.models.cnn`` on the same weights, exported from ``repro``, with
batch-norm statistics drawn from a seed in both packages (``repro``
initializes BN as the identity, which would hide it).

* emulated (``PAPER_DEFAULT``: EQ4, L=8): bit for bit, every head.
* the kernel backend (``PALLAS_TILED``; on the CPU the kernels' plain
  versions, weights prequantized): bit for bit, every head, against
  ``repro`` bound on a backend registered here whose conv is the oracle
  ``ref.bfp_conv2d_ref`` and whose matmul is the Pallas matmul in
  interpret mode (the Pallas conv does not run on this JAX version), and
  served through ``CnnServeEngine``.
* float (``policy=None``): the GEMMs are BLAS sums in another order than
  XLA's, so 1e-5 relative, and 1e-5 of the largest logit absolute.

BN, max/avg pooling, the residual adds, the inception concats and the
global average pool all come out bit-equal here (no tolerance needed
beyond the float GEMMs).
"""
import jax
import numpy as np
import pytest
import torch

from repro import engine as JEG
from repro.core.policy import PAPER_DEFAULT as J_PAPER_DEFAULT
from repro.core.policy import TPU_TILED as J_TPU_TILED
from repro.engine import backends as JBK
from repro.kernels import ops, ref
from repro.models.cnn import MODELS as JMODELS
from repro_torch import engine as EG
from repro_torch.convert import params_from_numpy
from repro_torch.core.policy import PALLAS_TILED, PAPER_DEFAULT
from repro_torch.models.cnn import MODELS
from repro_torch.serve.cnn import CnnServeEngine
from test_torch_util import assert_bits_equal, normal, t

MODEL_NAMES = ("resnet18", "resnet50", "googlenet")
_REF = "torch_models_ref"


def _ref_matmul(x2d, w, pol, key=None):
    return ops.bfp_matmul(x2d, w, pol, interpret=True)


def _ref_conv(x, w, pol, stride, padding, key=None):
    return ref.bfp_conv2d_ref(x, w, pol.l_i, pol.l_w, pol.block_k, stride,
                              padding)


def jax_params(name):
    """``repro``'s reduced init from seed 0 as numpy; jit returns the
    Python ints of the tree (``meta``, ``fc1_in``) as 0-d arrays, which go
    back to Python scalars.  The key is XLA's RngBitGenerator ("rbg"),
    which compiles the init about twice as fast as threefry; any seeded
    weights serve the parity."""
    key = jax.random.key(0, impl="unsafe_rbg")
    out = jax.jit(lambda k: JMODELS[name].init(k))(key)
    return jax.tree_util.tree_map(
        lambda a: a.item() if a.ndim == 0 else np.asarray(a), out)


def with_bn_from_seed(tree, rng):
    """Every BN of ``tree`` with statistics and affine terms drawn from
    ``rng`` (gamma, var in [0.5, 1.5); beta, mean ~ 0.1 N(0, 1))."""
    if isinstance(tree, dict):
        if set(tree) == {"gamma", "beta", "mean", "var"}:
            c = tree["gamma"].shape[0]
            return {"gamma": rng.uniform(0.5, 1.5, c).astype(np.float32),
                    "beta": (0.1 * rng.standard_normal(c)).astype(np.float32),
                    "mean": (0.1 * rng.standard_normal(c)).astype(np.float32),
                    "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
        return {k: with_bn_from_seed(v, rng) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(with_bn_from_seed(v, rng) for v in tree)
    return tree


def _heads(out):
    return tuple(np.asarray(h) for h in out) if isinstance(out, tuple) \
        else (np.asarray(out),)


def _port_heads(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.fixture(scope="module")
def ref_backend():
    JEG.register_backend(_REF, _ref_matmul, conv=_ref_conv)
    yield _REF
    JBK._REGISTRY.pop(_REF, None)


@pytest.fixture(scope="module", params=MODEL_NAMES)
def model(request, ref_backend):
    """(name, numpy params, images, reference heads per policy)."""
    name = request.param
    params = with_bn_from_seed(jax_params(name), np.random.default_rng(1))
    hw = JMODELS[name].reduced_hw
    images = normal((3, hw, hw, 3), seed=len(name))
    apply = JMODELS[name].apply
    kernel_pol = J_TPU_TILED.with_(backend=ref_backend,
                                   straight_through=False)
    want = {}
    for label, pol in (("float", None), ("emulated", J_PAPER_DEFAULT),
                       ("kernel", kernel_pol)):
        # weights quantized in the forward (bit-identical to prequant in
        # repro; its eager prequantization compiles op by op and is slow)
        plan = JEG.bind(params, pol, tree="cnn", strict=True,
                        prequantize=False)
        want[label] = _heads(plan.jit_forward(apply)(images))
    return name, params, images, want


def test_init_tree_matches_repro(model):
    """Same keys, shapes and Python ints as ``repro``'s reduced init."""
    name, params, _, _ = model
    mine = MODELS[name].init(torch.Generator().manual_seed(0), device="cpu")

    def walk(a, b, path):
        if isinstance(b, dict):
            assert isinstance(a, dict) and a.keys() == b.keys(), path
            for k in b:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(b, (list, tuple)):
            assert type(a) is type(b) and len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}/{i}")
        elif isinstance(b, np.ndarray):
            assert tuple(a.shape) == b.shape, path
        else:
            assert a == b and type(a) is type(b), path

    walk(mine, params, name)
    assert MODELS[name].input_shape() == JMODELS[name].input_shape()


def test_float_apply_matches_repro(model):
    """policy=None: float GEMMs in another summation order, 1e-5."""
    name, params, images, want = model
    got = _port_heads(MODELS[name].apply(params_from_numpy(params, "cpu"),
                                         t(images), None))
    assert len(got) == len(want["float"])
    for g, w in zip(got, want["float"]):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())


def test_emulated_apply_matches_repro(model):
    """The paper's policy on the emulated datapath, weights prequantized
    at bind (per-column sidecars), every head bit-equal."""
    name, params, images, want = model
    plan = EG.bind(params_from_numpy(params, "cpu"), PAPER_DEFAULT,
                   tree="cnn", strict=True, device="cpu")
    assert {s.backend.name for s in plan.sites.values()} == {"emulated"}
    got = _port_heads(plan.jit_forward(MODELS[name].apply)(t(images)))
    for g, w in zip(got, want["emulated"], strict=True):
        assert_bits_equal(g, w)


def test_kernel_backend_apply_matches_repro(model):
    """``PALLAS_TILED`` strict on the kernels' plain versions: K a
    multiple of 128 runs the prequant conv/matmul, any other K the
    inline-weight one; every head bit-equal."""
    name, params, images, want = model
    plan = EG.bind(params_from_numpy(params, "cpu"),
                   PALLAS_TILED.with_(straight_through=False), tree="cnn",
                   strict=True, device="cpu")
    assert {s.backend.name for s in plan.sites.values()} == {"pallas"}
    assert any(s.prequantized for s in plan.sites.values())
    assert not all(s.prequantized for s in plan.sites.values())
    got = _port_heads(plan.jit_forward(MODELS[name].apply)(t(images)))
    for g, w in zip(got, want["kernel"], strict=True):
        assert_bits_equal(g, w)


def test_served_logits_match_repro(model):
    """Three requests through ``CnnServeEngine`` at bucket 2 (the third
    padded with a duplicate row): head 0 of the reference, bit for bit."""
    name, params, images, want = model
    eng = CnnServeEngine(params_from_numpy(params, "cpu"),
                         MODELS[name].apply,
                         PALLAS_TILED.with_(straight_through=False),
                         slots=2, buckets=(2,), strict_backend=True,
                         device="cpu")
    reqs = [eng.submit(image=t(images[i])) for i in range(3)]
    eng.run()
    assert eng.stats["completed"] == 3 and eng.ncalls == 2
    assert eng.stats["failed"] == 0 and eng.stats["float_retries"] == 0
    assert_bits_equal(np.stack([r.logits for r in reqs]), want["kernel"][0])


def test_meta_ints_pass_through_convert_and_bind():
    params = jax_params("resnet18")
    assert params["meta"] == (18, (1, 1, 1, 1), False)
    tp = params_from_numpy(params, "cpu")
    plan = EG.bind(tp, PALLAS_TILED, device="cpu")
    for tree in (tp, plan.params):
        assert tree["meta"] == (18, (1, 1, 1, 1), False)
        assert type(tree["meta"][0]) is int and \
            type(tree["meta"][2]) is bool
    g = MODELS["googlenet"].init(torch.Generator().manual_seed(0),
                                 device="cpu")
    gplan = EG.bind(g, PALLAS_TILED, device="cpu")
    assert gplan.params["loss1"]["fc1_in"] == g["loss1"]["fc1_in"] == 256
    assert "loss1/fc1_in" not in gplan.sites


@pytest.mark.parametrize("name", ["lenet", "cifarnet"])
def test_small_models_emulated_match_repro(name):
    params = jax_params(name)
    hw = JMODELS[name].reduced_hw
    ch = JMODELS[name].in_ch
    images = normal((2, hw, hw, ch), seed=7)
    jplan = JEG.bind(params, J_PAPER_DEFAULT, tree="cnn", prequantize=False)
    want = np.asarray(jplan.jit_forward(JMODELS[name].apply)(images))
    plan = EG.bind(params_from_numpy(params, "cpu"), PAPER_DEFAULT,
                   tree="cnn", device="cpu")
    assert_bits_equal(MODELS[name].apply(plan.params, t(images), plan), want)
    mine = MODELS[name].init(torch.Generator().manual_seed(0), device="cpu")
    assert {k: tuple(v["w"].shape) for k, v in mine.items()} == \
        {k: v["w"].shape for k, v in params.items()}
