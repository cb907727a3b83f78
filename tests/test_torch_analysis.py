"""``repro_torch.models.cnn.analysis`` (the paper's Table-4 analysis)
against ``repro.models.cnn.analysis``, live.

The rows of ``analyze_vgg`` (reduced VGG16, 6 layers, biases restored,
analytic inheritance) and of ``analyze_model`` (reduced ResNet-18 with
projection shortcuts, reduced GoogLeNet at width 0.125 and 64x64 with
its aux heads, LeNet under a PolicyMap that pins ``c1`` to float, both
inheritance modes) are computed by both packages on the same parameters
(exported from ``repro``) and images, under the paper's ``BFPPolicy()``
(EQ4, L=8; the emulated datapath, bit-equal between the packages).  The
SNRs are float32 reductions in another order, so rows agree to 1e-3 dB;
a non-finite value must be the same value (reduced GoogLeNet's
``inc5a/b5`` row holds a -inf that ``repro``'s own test records as R2).
The rows are not held against ``repro``'s ``_VGG_TABLE4_PINNED``, which
no longer reproduces (R2).
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.core.policy import BFPPolicy as JBFPPolicy
from repro.engine import PolicyMap as JPolicyMap
from repro.models.cnn import analysis as JA
from repro.models.cnn import googlenet as jgooglenet
from repro.models.cnn import resnet as jresnet
from repro.models.cnn import small as jsmall
from repro.models.cnn import vgg as jvgg
from repro_torch import engine as EG
from repro_torch.convert import params_from_numpy
from repro_torch.core.policy import BFPPolicy
from repro_torch.engine import PolicyMap
from repro_torch.models.cnn import analysis as A
from repro_torch.models.cnn import googlenet, resnet, small, vgg
from test_torch_util import normal, t


def _init(fn):
    """``repro``'s init from key 0 as numpy; jit returns the Python ints
    of the tree (``meta``, ``fc1_in``) as 0-d arrays, which go back to
    Python scalars."""
    out = jax.jit(fn)(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(
        lambda a: a.item() if a.ndim == 0 else np.asarray(a), out)


def assert_rows_close(got, want):
    """Same rows in the same order; every SNR within 1e-3 dB, non-finite
    values equal as values."""
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        g, w = dataclasses.astuple(g), dataclasses.astuple(w)
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, str):
                assert a == b
            elif np.isfinite(b):
                assert abs(a - b) < 1e-3, (g[0], a, b)
            else:
                assert a == b, (g[0], a, b)


@pytest.fixture(scope="module")
def vgg_case():
    params = _init(lambda k: jvgg.init(k, 10, width_mult=0.25, input_hw=32,
                                       fc_dim=64))
    x = normal((2, 32, 32, 3), seed=0)
    return params, x, JA.analyze_vgg(params, x, JBFPPolicy(), max_layers=6)


def test_analyze_vgg_matches_repro(vgg_case):
    params, x, want = vgg_case
    got = A.analyze_vgg(params_from_numpy(params, "cpu"), t(x), BFPPolicy(),
                        max_layers=6)
    assert [r.name for r in got] == vgg.conv_names()[:6]
    assert all(isinstance(r, A.LayerRow) for r in got)
    assert_rows_close(got, want)
    for r in got:               # the paper's envelope, as repro's test
        assert abs(r.output_ex - r.output_multi) < 8.9, r
        assert abs(r.relu_ex - r.output_ex) < 1.5, r


@pytest.fixture(scope="module")
def resnet18_case():
    params = _init(lambda k: jresnet.init(k, 18, 10, width_mult=0.25,
                                          stage_depths=(1, 1, 1, 1)))
    x = normal((2, 32, 32, 3), seed=1)
    return params, x, JA.analyze_model(jresnet.apply, params, x,
                                       JBFPPolicy())


def test_analyze_model_resnet18_matches_repro(resnet18_case):
    params, x, want = resnet18_case
    got = A.analyze_model(resnet.apply, params_from_numpy(params, "cpu"),
                          t(x), BFPPolicy())
    assert any("proj" in r.path for r in got if r.kind == "conv")
    assert_rows_close(got, want)


@pytest.fixture(scope="module")
def googlenet_case():
    params = _init(lambda k: jgooglenet.init(k, 10, width_mult=0.125))
    x = normal((2, 64, 64, 3), seed=2)
    return params, x, JA.analyze_model(jgooglenet.apply, params, x,
                                       JBFPPolicy())


def test_analyze_model_googlenet_matches_repro(googlenet_case):
    params, x, want = googlenet_case
    got = A.analyze_model(googlenet.apply, params_from_numpy(params, "cpu"),
                          t(x), BFPPolicy())
    assert {"inc3a/b1", "inc3a/b3", "inc3a/b5", "inc3a/bp", "loss1/conv",
            "loss1/fc1", "fc"} <= {r.path for r in got}
    assert_rows_close(got, want)


@pytest.fixture(scope="module")
def lenet_case():
    params = _init(jsmall.lenet_init)
    x = normal((2, 28, 28, 1), seed=3)
    pm = JPolicyMap.of(("^c1$", None),
                       default=JBFPPolicy(straight_through=False))
    want = {mode: JA.analyze_model(jsmall.lenet_apply, params, x, pm,
                                   inheritance=mode)
            for mode in ("analytic", "measured")}
    return params, x, want


@pytest.mark.parametrize("mode", ["analytic", "measured"])
def test_analyze_model_policymap_skips_float_sites(lenet_case, mode):
    params, x, want = lenet_case
    pm = PolicyMap.of(("^c1$", None), default=BFPPolicy())
    got = A.analyze_model(small.lenet_apply, params_from_numpy(params, "cpu"),
                          t(x), pm, inheritance=mode)
    assert [r.path for r in got] == ["c2", "fc1", "fc2"]
    assert_rows_close(got, want[mode])


def test_analyze_model_refuses_prequant_params_and_bad_modes(lenet_case):
    params, x, _ = lenet_case
    tp = params_from_numpy(params, "cpu")
    pol = BFPPolicy(straight_through=False)
    with pytest.raises(ValueError, match="float weights"):
        A.analyze_model(small.lenet_apply, EG.prequantize_cnn(tp, pol),
                        t(x), pol)
    with pytest.raises(ValueError, match="inheritance"):
        A.analyze_model(small.lenet_apply, tp, t(x), pol,
                        inheritance="inherited")
    # max_sites stops the rows (the forward still runs in full)
    rows = A.analyze_model(small.lenet_apply, tp, t(x), pol, max_sites=2)
    assert [r.path for r in rows] == ["c1", "c2"]
