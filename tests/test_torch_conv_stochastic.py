"""STOCHASTIC convolutions: ``engine.conv2d(noise=)``, ``conv2d_im2col``
and ``Plan.conv2d`` against ``repro.engine.conv2d(key=)`` fed the same
uniform draws.

``repro`` takes STOCHASTIC convs down the im2col route and draws its
noise in the shape it quantizes: ``[M, K//bk, bk]`` for TILED, ``[M, K]``
for a paper scheme, M = B*OH*OW rows of the patch matrix in HWIO-major K
order.  The draws cross to the port as numpy.  Weights are prequantized
(round-to-nearest), so only x is rounded stochastically; the emulated
prequant datapath is integer-exact, so the outputs are bit-equal.
"""
import jax
import numpy as np
import pytest

from repro import engine as JEG
from repro.core import bfp as jbfp
from repro.core import prequant as jpq
from repro.core.policy import BFPPolicy as JPolicy
from repro_torch import engine as EG
from repro_torch.core.bfp import Rounding, Scheme
from repro_torch.core.policy import BFPPolicy
from test_torch_util import assert_bits_equal, normal, t, to_numpy_tree

# (label, scheme, block_k, kernel, stride, padding, C)
CASES = [("tiled-3x3-same", Scheme.TILED, 8, 3, 1, "SAME", 8),
         ("tiled-3x3-s2-valid", Scheme.TILED, 16, 3, 2, "VALID", 16),
         ("tiled-1x1-s2", Scheme.TILED, 8, 1, 2, "SAME", 16),
         ("eq4-3x3-same", Scheme.EQ4, None, 3, 1, "SAME", 4)]


def _geometry(case):
    _, scheme, bk, kk, s, pad, c = case
    h, w = 9, 8
    oh, ow = ((-(-h // s), -(-w // s)) if pad == "SAME"
              else ((h - kk) // s + 1, (w - kk) // s + 1))
    m, k = 2 * oh * ow, kk * kk * c
    return (m, k // bk, bk) if scheme is Scheme.TILED else (m, k)


def _inputs(case):
    _, _, _, kk, _, _, c = case
    return (normal((2, 9, 8, c), seed=kk + c),
            normal((kk, kk, c, 5), seed=c, scale=0.2))


def _jpol(case, rounding):
    _, scheme, bk, *_ = case
    return JPolicy(scheme=jbfp.Scheme(scheme.value), block_k=bk,
                   rounding=jbfp.Rounding(rounding.value))


@pytest.fixture(scope="module")
def refs():
    key = jax.random.PRNGKey(7)

    def ref_fn(ops):
        out = []
        for case, (x, w) in zip(CASES, ops):
            _, _, _, _, s, pad, _ = case
            side = jpq.prequant_conv_leaf(w, _jpol(case, Rounding.ROUND))
            ck = jax.random.fold_in(key, len(out))
            out.append((side, jax.random.uniform(ck, _geometry(case)),
                        JEG.conv2d(x, side, _jpol(case, Rounding.STOCHASTIC),
                                   stride=s, padding=pad, key=ck)))
        return out

    return to_numpy_tree(jax.jit(ref_fn)([_inputs(c) for c in CASES]))


@pytest.mark.parametrize("i", range(len(CASES)), ids=[c[0] for c in CASES])
def test_stochastic_conv_matches_repro_key(refs, i):
    case = CASES[i]
    _, scheme, bk, _, s, pad, _ = case
    x, _ = _inputs(case)
    side, noise, want = refs[i]
    wq = {"m": t(side["m"]), "s": t(side["s"])}
    pol = BFPPolicy(scheme=scheme, block_k=bk, rounding=Rounding.STOCHASTIC)
    got = EG.conv2d(t(x), wq, pol, stride=s, padding=pad, noise=t(noise))
    assert_bits_equal(got, want)
    # the same draws through the im2col entry point and a bound plan
    assert_bits_equal(EG.conv2d_im2col(t(x), wq, pol, s, pad,
                                       noise=t(noise)), want)
    plan = EG.bind({"conv1": {"w": wq}}, pol, tree="cnn", prequantize=False,
                   device="cpu")
    assert_bits_equal(plan.conv2d(t(x), plan.params["conv1"]["w"],
                                  path="conv1", stride=s, padding=pad,
                                  noise=t(noise)), want)
    assert_bits_equal(EG.conv2d(t(x), wq, plan, path="conv1", stride=s,
                                padding=pad, noise=t(noise)), want)


def test_stochastic_conv_without_noise_raises_as_repro_without_key():
    case = CASES[0]
    x, w = _inputs(case)
    pol = BFPPolicy(scheme=Scheme.TILED, block_k=8,
                    rounding=Rounding.STOCHASTIC)
    wq = EG.prequantize_cnn({"conv1": {"w": t(w)}},
                            pol.with_(rounding=Rounding.ROUND))["conv1"]["w"]
    with pytest.raises(ValueError, match="stochastic rounding requires"):
        EG.conv2d(t(x), wq, pol)
    with pytest.raises(ValueError, match="stochastic rounding requires"):
        JEG.conv2d(x, {"m": np.asarray(wq["m"]), "s": np.asarray(wq["s"])},
                   _jpol(case, Rounding.STOCHASTIC))
