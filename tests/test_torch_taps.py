"""``repro_torch.engine.taps`` against ``repro.engine.taps``.

On the same LeNet and reduced VGG16 parameters (exported from
``repro``), the events of one forward — their ``(path, kind, backend)``
order and each ``y`` — equal ``repro``'s, through the per-call engine
and through a bound plan, on the paper's EQ4 policy (the emulated
datapath, bit for bit) and on TILED (the kernels' plain versions here,
``repro`` on a backend registered as ``test_torch_models_cnn.py`` does:
the Pallas matmul in interpret mode and the conv oracle).  The port's
kernel backend is named "pallas"; ``repro``'s oracle backend has a name
of its own, which is mapped.  Then the tap semantics of the port alone:
wire-format outputs arrive dequantized, a transforming tap's replacement
is adopted (and requantized under ``out_policy``), ``want_float``
attaches the float reference, ``Plan.jit_forward`` emits nothing, and a
``CnnServeEngine(jit=False)`` emits what a direct apply emits.
"""
import importlib

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
from repro_torch.core.policy import PAPER_DEFAULT, PALLAS_TILED
from repro_torch.core.prequant import dequantize_act, prequant_act
from repro_torch.models.cnn import MODELS
from repro_torch.serve.cnn import CnnServeEngine
from test_torch_util import assert_bits_equal, normal, t, to_numpy_tree

# the module (``repro_torch.engine.taps`` is the function once the package
# has imported it, as in ``repro``)
TAPS = importlib.import_module("repro_torch.engine.taps")

_REF = "torch_taps_ref"
# TILED at block 32 (no K of these models is a multiple of 128 at the
# start; the kernels zero-pad a ragged K)
TILED = PALLAS_TILED.with_(block_k=32, straight_through=False)
EQ4 = PAPER_DEFAULT.with_(straight_through=False)


def _ref_matmul(x2d, w, pol, key=None):
    return ops.bfp_matmul(x2d, w, pol, interpret=True)


def _ref_conv(x, w, pol, stride, padding, key=None):
    return ref.bfp_conv2d_ref(x, w, pol.l_i, pol.l_w, pol.block_k, stride,
                              padding)


def _jpol(label):
    if label == "eq4":
        return J_PAPER_DEFAULT.with_(straight_through=False)
    return J_TPU_TILED.with_(block_k=32, backend=_REF,
                             straight_through=False)


@pytest.fixture(scope="module")
def ref_backend():
    JEG.register_backend(_REF, _ref_matmul, conv=_ref_conv)
    yield _REF
    JBK._REGISTRY.pop(_REF, None)


def _jax_events(apply, params, x, policy):
    evs = []
    with JEG.taps(evs.append):
        apply(params, x, policy)
    return [(e.path, e.kind, e.backend, np.asarray(e.y)) for e in evs]


@pytest.fixture(scope="module", params=["lenet", "vgg16"])
def model(request, ref_backend):
    """(name, numpy params, images, repro's events per (route, policy)):
    ``repro`` runs eagerly (its events fire on concrete values only)."""
    name = request.param
    params = to_numpy_tree(jax.jit(JMODELS[name].init)(jax.random.PRNGKey(0)))
    images = normal((2, *JMODELS[name].input_shape()), seed=3)
    apply = JMODELS[name].apply
    want = {}
    for label in ("eq4", "tiled"):
        pol = _jpol(label)
        want["call", label] = _jax_events(apply, params, images, pol)
        plan = JEG.bind(params, pol, tree="cnn", strict=True,
                        prequantize=False)
        want["plan", label] = _jax_events(apply, plan.params, images, plan)
    return name, params, images, want


def _port_events(name, params, images, route, label):
    pol = EQ4 if label == "eq4" else TILED
    tp = params_from_numpy(params, "cpu")
    policy = (pol if route == "call" else
              EG.bind(tp, pol, tree="cnn", strict=True, device="cpu"))
    if route == "plan":
        tp = policy.params
    evs = []
    with torch.no_grad(), EG.taps(evs.append):
        MODELS[name].apply(tp, t(images), policy)
    return evs


@pytest.mark.parametrize("label", ["eq4", "tiled"])
@pytest.mark.parametrize("route", ["call", "plan"])
def test_events_match_repro(model, route, label):
    name, params, images, want = model
    evs = _port_events(name, params, images, route, label)
    backend = {"eq4": "emulated", "tiled": "pallas"}[label]
    assert [(e.path, e.kind, e.backend) for e in evs] == \
        [(p, k, backend if b in ("emulated", _REF) else b)
         for p, k, b, _ in want[route, label]]
    assert all(e.policy is not None and e.y_float is None for e in evs)
    for e, (*_, y) in zip(evs, want[route, label]):
        assert_bits_equal(e.y, y)


@pytest.fixture(scope="module")
def lenet():
    params = to_numpy_tree(jax.jit(JMODELS["lenet"].init)(
        jax.random.PRNGKey(0)))
    return params_from_numpy(params, "cpu")


def test_wire_output_arrives_dequantized_and_transform_is_requantized(
        lenet):
    x, w = t(normal((4, 64), seed=1)), t(normal((64, 32), seed=2,
                                                scale=0.1))
    pol = TILED
    opol = TILED.with_(block_k=16)
    seen = []
    with EG.taps(seen.append):
        out = EG.gemm(x, w, pol, path="fc1", out_policy=opol)
    assert set(out) == {"m", "s"} and len(seen) == 1
    assert isinstance(seen[0].y, torch.Tensor)
    assert_bits_equal(seen[0].y, dequantize_act(out).numpy())
    # a transforming tap's replacement lands before the requantization;
    # a later observer sees the replaced value
    later = []
    with EG.taps(lambda ev: ev.y * 4.0, transform=True), \
            EG.taps(later.append):
        got = EG.gemm(x, w, pol, path="fc1", out_policy=opol)
    want = prequant_act(dequantize_act(out) * 4.0, opol)
    assert_bits_equal(got["m"], want["m"].numpy())
    assert_bits_equal(got["s"], want["s"].numpy())
    assert_bits_equal(later[0].y, (seen[0].y * 4.0).numpy())
    # on a dense output the replacement is the output; None keeps it
    with EG.taps(lambda ev: torch.zeros_like(ev.y) if ev.path == "c2"
                 else None, transform=True):
        y1 = EG.conv2d(t(normal((2, 8, 8, 16), seed=4)), lenet["c2"]["w"],
                       EQ4, path="c2")
        y2 = EG.conv2d(t(normal((2, 8, 8, 16), seed=4)), lenet["c2"]["w"],
                       EQ4, path="other")
    assert not y1.any() and y2.abs().sum() > 0


def test_want_float_attaches_the_float_reference(lenet):
    x = t(normal((2, 28, 28, 1), seed=5))
    plain, flt = [], []
    with EG.taps(plain.append), EG.taps(flt.append, want_float=True):
        MODELS["lenet"].apply(lenet, x, EQ4)
    float_evs = []
    with EG.taps(float_evs.append):
        MODELS["lenet"].apply(lenet, x, None)
    assert [e.path for e in flt] == ["c1", "c2", "fc1", "fc2"]
    for e, fe in zip(flt, float_evs):
        # the same site in float on the BFP run's input
        want = (EG.conv2d_im2col(e.x, e.w, None, e.stride, e.padding)
                if e.kind == "conv" else e.x @ e.w)
        assert_bits_equal(e.y_float, want.numpy())
        assert fe.policy is None and fe.backend == "float"
    assert plain[0] is flt[0]        # one event object for every tap


def test_no_event_inside_jit_forward_and_none_without_taps(lenet,
                                                           monkeypatch):
    x = t(normal((2, 28, 28, 1), seed=6))
    plan = EG.bind(lenet, EQ4, tree="cnn", device="cpu")
    evs = []
    with EG.taps(evs.append):
        jitted = plan.jit_forward(MODELS["lenet"].apply)(x)
        assert evs == [] and TAPS.active()
        eager = MODELS["lenet"].apply(plan.params, x, plan)
    assert [e.path for e in evs] == ["c1", "c2", "fc1", "fc2"]
    assert_bits_equal(jitted, eager.numpy())
    # no tap registered: emit is never reached
    monkeypatch.setattr(TAPS, "emit", lambda *a, **k: pytest.fail("emit"))
    MODELS["lenet"].apply(plan.params, x, plan)


def test_served_events_match_a_direct_apply(lenet):
    """``repro``'s test_serve_taps_match_direct_path: a jit=False engine
    runs the same datapath as a direct apply, site for site."""
    plan = EG.bind(lenet, EQ4, tree="cnn", device="cpu")
    imgs = t(normal((4, 28, 28, 1), seed=7))
    direct_evs = []
    with EG.taps(direct_evs.append):
        direct = MODELS["lenet"].apply(plan.params, imgs, plan)
    serve_evs = []
    eng = CnnServeEngine(None, MODELS["lenet"].apply, plan, slots=4,
                         buckets=(4,), jit=False, device="cpu")
    reqs = [eng.submit(image=imgs[i]) for i in range(4)]
    with EG.taps(serve_evs.append):
        eng.run()
    assert [(e.path, e.kind, e.backend) for e in serve_evs] == \
           [(e.path, e.kind, e.backend) for e in direct_evs] == \
           [("c1", "conv", "emulated"), ("c2", "conv", "emulated"),
            ("fc1", "gemm", "emulated"), ("fc2", "gemm", "emulated")]
    for se, de in zip(serve_evs, direct_evs):
        assert_bits_equal(se.y, de.y.numpy())
    for i, r in enumerate(reqs):
        assert_bits_equal(r.logits, direct[i].numpy())
    # the shared (jit) forward serves the same logits and emits nothing
    jit_evs = []
    jeng = CnnServeEngine(None, MODELS["lenet"].apply, plan, slots=4,
                          buckets=(4,), device="cpu")
    jreqs = [jeng.submit(image=imgs[i]) for i in range(4)]
    with EG.taps(jit_evs.append):
        jeng.run()
    assert jit_evs == []
    assert_bits_equal(np.stack([r.logits for r in jreqs]),
                      np.stack([r.logits for r in reqs]))
