"""Port parity for the slice as a whole: reduced VGG16 served through
``engine.bind`` -> ``CnnServeEngine`` -> the kernels' CPU versions is
bit-equal to the JAX reference on the same weights.

The JAX side binds ``prequantize=False`` on a backend registered here
through ``repro.engine.register_backend``: its conv is the oracle
``ref.bfp_conv2d_ref`` and its matmul the Pallas kernel in interpret
mode (the Pallas conv does not run on this JAX version).  At block_k 8
only conv1_1 (K = 27) keeps that backend; every other site, where 8
divides K, runs the reference's emulated TILED datapath, which it
documents as bit-identical to the kernels — the oracle's 72-tile loops
would take XLA most of a minute to compile.  The port binds
``PALLAS_TILED`` with weights prequantized, so the parity also pins
prequant execution to inline quantization.
"""
import warnings

import jax
import numpy as np
import pytest
import torch

from repro import engine as JEG
from repro.core.policy import TPU_TILED as J_TPU_TILED
from repro.engine import PolicyMap as JPolicyMap
from repro.engine import backends as JBK
from repro.kernels import ops, ref
from repro.models.cnn import MODELS as JMODELS
from repro.models.cnn import vgg as jvgg
from repro_torch import engine as EG
from repro_torch.convert import params_from_numpy
from repro_torch.core.bfp import Rounding
from repro_torch.core.policy import PALLAS_TILED, PAPER_DEFAULT
from repro_torch.dist.sharding import DEFAULT_RULES
from repro_torch.models.cnn import MODELS, layers
from repro_torch.models.cnn import vgg
from repro_torch.serve.cnn import CnnServeEngine, default_buckets
from repro_torch.serve.degrade import (DeadlineExceeded, DegradeConfig,
                                       QueueOverloaded)
from test_torch_util import assert_bits_equal, normal, t, to_numpy_tree

_REF = "torch_parity_ref"
IMAGES = normal((3, 32, 32, 3), seed=11)


def _ref_matmul(x2d, w, pol, key=None):
    return ops.bfp_matmul(x2d, w, pol, interpret=True)


def _ref_conv(x, w, pol, stride, padding, key=None):
    return ref.bfp_conv2d_ref(x, w, pol.l_i, pol.l_w, pol.block_k, stride,
                              padding)


@pytest.fixture(scope="module")
def jax_params():
    """Reduced VGG16 from ``PRNGKey(0)``, exported as numpy."""
    init = jax.jit(lambda k: JMODELS["vgg16"].init(k))
    return to_numpy_tree(init(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def ref_backend():
    JEG.register_backend(_REF, _ref_matmul, conv=_ref_conv)
    yield _REF
    JBK._REGISTRY.pop(_REF, None)


# at reduced width no K is a multiple of 128 (27, 72, 144, ... 576, and
# 64 for the FC layers), so block_k 128 keeps every site inline; block_k
# 8 prequantizes all but conv1_1 (K = 27)
_INLINE = {128: set(vgg.conv_names()) | {"fc6", "fc7", "fc8"},
           8: {"conv1_1"}}


def _jax_policy(bk, backend):
    oracle = J_TPU_TILED.with_(block_k=bk, backend=backend,
                               straight_through=False)
    if bk == 128:
        return oracle
    return JPolicyMap.of(("^conv1_1$", oracle),
                         default=oracle.with_(backend="emulated"))


@pytest.mark.parametrize("bk", [128, 8])
def test_served_vgg16_bit_equal_to_jax(jax_params, ref_backend, bk):
    jplan = JEG.bind(jax_params, _jax_policy(bk, ref_backend), tree="cnn",
                     strict=True, prequantize=False)
    want = np.asarray(jplan.jit_forward(jvgg.apply)(IMAGES))

    plan = EG.bind(params_from_numpy(jax_params, "cpu"),
                   PALLAS_TILED.with_(block_k=bk, straight_through=False),
                   tree="cnn", strict=True, device="cpu")
    inline = {p for p, s in plan.sites.items() if not s.prequantized}
    assert inline == _INLINE[bk]
    assert all(s.backend.name == "pallas" for s in plan.sites.values())
    # buckets=(2,): the third request runs padded with a duplicate row
    eng = CnnServeEngine(None, vgg.apply, plan, slots=2, buckets=(2,),
                         device="cpu")
    reqs = [eng.submit(image=t(IMAGES[i])) for i in range(3)]
    eng.run()
    assert eng.stats["completed"] == 3 and eng.ncalls == 2
    assert eng.stats["failed"] == 0 and eng.stats["float_retries"] == 0
    assert_bits_equal(np.stack([r.logits for r in reqs]), want)
    assert_bits_equal(vgg.apply(plan.params, t(IMAGES), plan), want)


def test_float_serving_matches_jax_float(jax_params):
    """policy=None: the float backend's GEMMs are BLAS sums in another
    order than XLA's, so this one comparison takes a tolerance: 1e-5
    relative, and 1e-5 of the largest logit absolute for logits near 0."""
    want = np.asarray(jax.jit(lambda p, x: jvgg.apply(p, x, None))(
        jax_params, IMAGES))
    eng = CnnServeEngine(params_from_numpy(jax_params, "cpu"), vgg.apply,
                         None, slots=4, device="cpu")
    reqs = [eng.submit(image=t(IMAGES[i])) for i in range(3)]
    eng.run()
    got = np.stack([r.logits for r in reqs])
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_registry_spec_and_reduced_init_shapes(jax_params):
    spec = MODELS["vgg16"]
    assert spec.input_shape() == JMODELS["vgg16"].input_shape() == (32, 32, 3)
    assert spec.input_shape(reduced=False) == (224, 224, 3)
    mine = spec.init(torch.Generator().manual_seed(0), device="cpu")
    assert mine.keys() == jax_params.keys()
    for name in mine:
        for leaf in ("w", "b"):
            assert tuple(mine[name][leaf].shape) == \
                jax_params[name][leaf].shape
    assert vgg.conv_names() == jvgg.conv_names()


def test_bind_refuses_policies_the_kernels_cannot_run():
    """A strict bind refuses a policy the kernels cannot run; a
    non-strict one warns once per site and runs it on "emulated", as
    ``repro`` does.  ``PAPER_DEFAULT`` names "emulated" itself: no
    warning."""
    params = MODELS["vgg16"].init(torch.Generator().manual_seed(0),
                                  device="cpu")
    truncating = PALLAS_TILED.with_(rounding=Rounding.TRUNCATE)
    with pytest.raises(EG.BackendUnsupportedError, match="emulated"):
        EG.bind(params, truncating, strict=True, device="cpu")
    with pytest.warns(EG.BackendFallbackWarning) as rec:
        plan = EG.bind(params, truncating, device="cpu")
    assert len(rec) == len(plan.sites) == 16
    assert all(s.backend.name == "emulated" and s.fallback
               for s in plan.sites.values())
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        plan = EG.bind(params, PAPER_DEFAULT, device="cpu")
    assert all(s.backend.name == "emulated" and not s.fallback
               for s in plan.sites.values())
    # an LM tree binds on the LM walk (here: no GEMM weight, no site)
    assert dict(EG.bind({"embed": {}}, None, device="cpu").sites) == {}
    with pytest.raises(ValueError, match="tree must be"):
        EG.bind(params, None, tree="rnn", device="cpu")


def _tiny_params():
    g = torch.Generator().manual_seed(3)
    return {"fc": layers.dense_init(g, 12, 4, device="cpu")}


def _tiny_apply(params, x, policy):
    return layers.dense(params["fc"], x.reshape(x.shape[0], -1), policy,
                        path="fc")


def test_serve_engine_sheds_expires_and_batches():
    now = [0.0]
    eng = CnnServeEngine(_tiny_params(), _tiny_apply,
                         PALLAS_TILED.with_(block_k=4), slots=2,
                         max_queue=3, clock=lambda: now[0], device="cpu")
    assert eng.plan.site("fc").prequantized
    imgs = normal((4, 2, 2, 3), seed=5)
    reqs = [eng.submit(image=t(imgs[i])) for i in range(3)]
    with pytest.raises(QueueOverloaded):
        eng.submit(image=t(imgs[3]))
    reqs[2].deadline = -1.0                       # already past
    eng.run()
    assert eng.stats == {"shed": 1, "expired": 1, "failed": 0,
                         "completed": 2, "float_retries": 0,
                         "degraded_served": 0}
    assert isinstance(reqs[2].error, DeadlineExceeded)
    want = _tiny_apply(eng.plan.params, t(imgs[:2]), eng.plan).numpy()
    assert_bits_equal(np.stack([r.logits for r in reqs[:2]]), want)
    with pytest.raises(ValueError, match="shape"):
        eng.submit(image=torch.zeros(3, 2, 3))
    assert default_buckets(6) == (1, 2, 4, 6)


def test_serve_engine_bucket_barrier_degrade_and_float_retry():
    params = _tiny_params()
    eng = CnnServeEngine(params, _tiny_apply, PALLAS_TILED.with_(block_k=4),
                         slots=2, batching="bucket", max_wait=1,
                         fallback_policy=PALLAS_TILED.with_(block_k=4, l_w=4,
                                                            l_i=4),
                         degrade=DegradeConfig(queue_high=1, trip_steps=1),
                         device="cpu")
    img = t(normal((2, 2, 3), seed=6))
    eng.submit(image=img)
    assert eng.step() == 1 and eng.ncalls == 0    # barrier defers once
    eng.run()
    assert eng.stats["completed"] == 1 and eng.ncalls == 1
    assert eng.stats["degraded_served"] == 1      # tripped at depth 1

    def nan_bfp(params, x, policy):
        out = _tiny_apply(params, x, policy)
        return out * float("nan") if policy is not None else out

    eng = CnnServeEngine(params, nan_bfp, PALLAS_TILED.with_(block_k=4),
                         slots=2, device="cpu")
    req = eng.submit(image=img)
    eng.run()
    assert eng.stats["float_retries"] == 1 and np.isfinite(req.logits).all()
    # no mesh: DEFAULT_RULES kept for a later binding, or the rules given
    # (tests/test_torch_dist_engine.py serves on meshes)
    assert eng.mesh is None and eng.rules == DEFAULT_RULES
    assert CnnServeEngine(params, _tiny_apply, None, rules={"batch": None},
                          device="cpu").rules == {"batch": None}
    with pytest.raises(ValueError, match="params=None"):
        CnnServeEngine(params, _tiny_apply, eng.plan, device="cpu")
    # engines bound to one plan share one forward object
    twin = CnnServeEngine(None, nan_bfp, eng.plan, device="cpu")
    assert twin._fwd is eng._fwd is eng.plan.jit_forward(nan_bfp)


def test_layers_match_reference():
    """Pooling and BN of the port against ``repro.models.cnn.layers``.
    Max pool and ReLU are exact; averages, variances and rsqrt are float
    reductions whose order or last ulp differs between XLA and PyTorch,
    so those compare within 1e-6 relative (f32 carries ~6e-8)."""
    from repro.models.cnn import layers as jlayers
    x = normal((2, 7, 6, 5), seed=9)
    bn = {"gamma": normal(5, seed=1), "beta": normal(5, seed=2),
          "mean": normal(5, seed=3), "var": np.abs(normal(5, seed=4)) + 0.5}

    def ref_fn(x, bn):
        return {"max_valid": jlayers.max_pool(x, 2, 2, "VALID"),
                "max_same": jlayers.max_pool(x, 3, 2, "SAME"),
                "avg_same": jlayers.avg_pool(x, 3, 2, "SAME"),
                "gap": jlayers.global_avg_pool(x),
                "bn": jlayers.batchnorm(bn, x),
                "bn_train": jlayers.batchnorm(bn, x, training=True),
                "relu": jlayers.relu(x)}

    want = to_numpy_tree(jax.jit(ref_fn)(x, bn))
    xt, bnt = t(x), {k: t(v) for k, v in bn.items()}
    assert_bits_equal(layers.max_pool(xt, 2, 2, "VALID"), want["max_valid"])
    assert_bits_equal(layers.max_pool(xt, 3, 2, "SAME"), want["max_same"])
    assert_bits_equal(layers.relu(xt), want["relu"])
    for got, key in ((layers.avg_pool(xt, 3, 2, "SAME"), "avg_same"),
                     (layers.global_avg_pool(xt), "gap"),
                     (layers.batchnorm(bnt, xt), "bn"),
                     (layers.batchnorm(bnt, xt, training=True), "bn_train")):
        np.testing.assert_allclose(got.numpy(), want[key], rtol=1e-6,
                                   atol=1e-6)
    init = layers.batchnorm_init(5, device="cpu")
    assert set(init) == set(jlayers.batchnorm_init(5))
