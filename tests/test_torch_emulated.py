"""Port parity for the emulated datapath: ``repro_torch.core.bfp_dot``
and the "emulated" backend against ``repro.core.bfp_dot`` on the CPU.

Bit for bit wherever ``repro`` is integer-exact: every scheme (EQ2-EQ5,
TILED) and rounding, the int32-safe K-chunking of ``_int_matmul`` (its
f32 chunk partials summed in chunk order) and the TILED sums over 64 and
392 K-tiles and over fc6's 196 prequant tiles (summed in tile order:
XLA:CPU's ``jnp.sum`` order matched at every count tried), prequantized
weights, and STOCHASTIC rounding on JAX's own noise.  The one tolerance: where an operand stays
float (``quantize_inputs`` or ``quantize_weights`` off) the product is a
float BLAS GEMM whose summation order differs between XLA and PyTorch,
and straight-through gradients are such GEMMs too — 1e-5 relative, and
1e-5 of the largest magnitude absolute.

Also pinned: ``select_backend`` (non-strict) downgrades a policy the
kernels cannot run to "emulated" with a ``BackendFallbackWarning``, as
``repro`` does; strict mode raises.
"""
import warnings

import jax
import numpy as np
import pytest
import torch

from repro import engine as JEG
from repro.core import bfp as jbfp
from repro.core.bfp_dot import bfp_matmul_2d as j_matmul_2d
from repro.core.bfp_dot import bfp_matmul_2d_prequant as j_matmul_2d_prequant
from repro.core import prequant as jpq
from repro.core.policy import BFPPolicy as JPolicy
from repro_torch import engine as EG
from repro_torch.core.bfp_dot import (bfp_dot, bfp_matmul_2d,
                                      bfp_matmul_2d_prequant)
from repro_torch.core.bfp import Rounding, Scheme
from repro_torch.core.policy import PAPER_DEFAULT, BFPPolicy
from repro_torch.engine import backends as BK
from test_torch_util import assert_bits_equal, normal, t, to_numpy_tree

ROUNDINGS = (Rounding.ROUND, Rounding.TRUNCATE)

# (label, scheme, rounding, L, block_k, B, K, N)
EM_CASES = [(f"{s.value}-{r.value}", s, r, 8, 32, 6, 96, 10)
            for s in Scheme for r in ROUNDINGS]
EM_CASES += [
    ("eq4-chunked-L12", Scheme.EQ4, Rounding.ROUND, 12, None, 5, 600, 7),
    ("eq3-chunked-L12", Scheme.EQ3, Rounding.TRUNCATE, 12, None, 5, 600, 7),
    ("tiled-64tiles-L4", Scheme.TILED, Rounding.ROUND, 4, 8, 4, 512, 9),
    ("tiled-392tiles-L4", Scheme.TILED, Rounding.ROUND, 4, 8, 3, 3136, 5),
    ("tiled-wholeK", Scheme.TILED, Rounding.ROUND, 8, None, 4, 200, 9),
]


def _policy(cls, scheme, rounding, l, bk):
    """The policy in either package (``cls`` = its BFPPolicy), its enums
    matched by value."""
    if cls is JPolicy:
        scheme, rounding = (jbfp.Scheme(scheme.value),
                            jbfp.Rounding(rounding.value))
    return cls(l_w=l, l_i=l, scheme=scheme, block_k=bk, rounding=rounding)


def _operands(case):
    _, _, _, _, _, b, k, n = case
    x = normal((b, k), seed=b + k)
    x[1] = 0.0                                    # an all-zero row
    w = normal((k, n), seed=n, scale=0.1)
    w[:, 2] = 0.0                                 # an all-zero column
    return x, w


# prequant: (label, policy scheme, sidecar block, rounding, L, B, K, N);
# EQ3/EQ4 take per-column sidecars (t == 1), TILED and "eq4 over a TILED
# sidecar" the per-tile route
PQ_CASES = [("eq4", Scheme.EQ4, None, Rounding.ROUND, 8, 6, 96, 10),
            ("eq3", Scheme.EQ3, None, Rounding.TRUNCATE, 8, 6, 96, 10),
            ("eq4-chunked-L12", Scheme.EQ4, None, Rounding.ROUND, 12, 5,
             600, 7),
            ("tiled", Scheme.TILED, 32, Rounding.ROUND, 8, 6, 96, 10),
            ("eq4-over-tiles", Scheme.EQ4, 32, Rounding.ROUND, 8, 6, 96, 10),
            ("tiled-196tiles", Scheme.TILED, 128, Rounding.ROUND, 8, 3,
             25088, 5),
            ("tiled-stochastic", Scheme.TILED, 32, Rounding.STOCHASTIC, 8,
             6, 96, 10),
            ("eq4-stochastic", Scheme.EQ4, None, Rounding.STOCHASTIC, 8, 6,
             96, 10),
            ("eq5-stochastic", Scheme.EQ5, None, Rounding.STOCHASTIC, 6, 6,
             96, 10)]


def _pq_noise_shape(case):
    _, scheme, bk, _, _, b, k, _ = case
    if scheme is Scheme.TILED:
        return (b, k // bk, bk)       # the reference quantizes [B, t, bk]
    return (b, k)


@pytest.fixture(scope="module")
def refs():
    """Every case of the reference, in one compiled program."""
    key = jax.random.PRNGKey(3)
    em_ops = [_operands(c) for c in EM_CASES]
    pq_ops = [_operands((None,) * 5 + c[5:]) for c in PQ_CASES]

    def ref_fn(em_ops, pq_ops, key):
        em = [j_matmul_2d(x, w, _policy(JPolicy, *c[1:5]))
              for c, (x, w) in zip(EM_CASES, em_ops)]
        pq = []
        for c, (x, w) in zip(PQ_CASES, pq_ops):
            _, scheme, bk, rd, l = c[:5]
            side = jpq.prequant_leaf(w, JPolicy(l_w=l, block_k=bk))
            pol = _policy(JPolicy, scheme, rd, l, bk)
            noise = jax.random.uniform(key, _pq_noise_shape(c))
            pq.append((side, j_matmul_2d_prequant(
                x, side["m"], side["s"], pol,
                key if rd is Rounding.STOCHASTIC else None), noise))
        return em, pq

    return to_numpy_tree(jax.jit(ref_fn)(em_ops, pq_ops, key))


@pytest.mark.parametrize("i", range(len(EM_CASES)),
                         ids=[c[0] for c in EM_CASES])
def test_bfp_matmul_2d_matches_repro(refs, i):
    case = EM_CASES[i]
    x, w = _operands(case)
    got = bfp_matmul_2d(t(x), t(w), _policy(BFPPolicy, *case[1:5]))
    assert_bits_equal(got, refs[0][i])


@pytest.mark.parametrize("i", range(len(PQ_CASES)),
                         ids=[c[0] for c in PQ_CASES])
def test_bfp_matmul_2d_prequant_matches_repro(refs, i):
    case = PQ_CASES[i]
    _, scheme, bk, rd, l = case[:5]
    x, _ = _operands((None,) * 5 + case[5:])
    side, want, noise = refs[1][i]
    got = bfp_matmul_2d_prequant(
        t(x), t(side["m"]), t(side["s"]),
        _policy(BFPPolicy, scheme, rd, l, bk),
        t(noise) if rd is Rounding.STOCHASTIC else None)
    assert_bits_equal(got, want)


#: (quantize_inputs, quantize_weights) of the float-operand routes
_FLOAT_OPERANDS = {"x_float": (False, True), "w_float": (True, False),
                   "both_float": (False, False)}


@pytest.fixture(scope="module")
def float_operand_refs():
    x, w = _operands(EM_CASES[0])

    def ref_fn(x, w):
        out = {}
        for name, (qi, qw) in _FLOAT_OPERANDS.items():
            pol = JPolicy(quantize_inputs=qi, quantize_weights=qw)
            out[name] = j_matmul_2d(x, w, pol)
        side = jpq.prequant_leaf(w, JPolicy())
        out["pq"] = j_matmul_2d_prequant(
            x, side["m"], side["s"], JPolicy(quantize_inputs=False))
        return out, side

    return to_numpy_tree(jax.jit(ref_fn)(x, w))


def test_float_operand_paths_match_repro_within_blas_tolerance(
        float_operand_refs):
    """One operand float: a float GEMM, 1e-5 relative (BLAS order)."""
    x, w = _operands(EM_CASES[0])
    want, side = float_operand_refs
    for name, (qi, qw) in _FLOAT_OPERANDS.items():
        got = bfp_matmul_2d(t(x), t(w), BFPPolicy(quantize_inputs=qi,
                                                  quantize_weights=qw))
        np.testing.assert_allclose(got.numpy(), want[name], rtol=1e-5,
                                   atol=1e-5 * np.abs(want[name]).max())
    got = bfp_matmul_2d_prequant(t(x), t(side["m"]), t(side["s"]),
                                 BFPPolicy(quantize_inputs=False))
    np.testing.assert_allclose(got.numpy(), want["pq"], rtol=1e-5,
                               atol=1e-5 * np.abs(want["pq"]).max())


def test_straight_through_gradients_match_repro():
    """The legacy STE: float gradients over the dequantized operands —
    float GEMMs, so 1e-5 relative."""
    x, w = _operands(EM_CASES[0])
    g = normal((x.shape[0], w.shape[1]), seed=4)
    pol = BFPPolicy(scheme=Scheme.TILED, block_k=32)
    jpol = JPolicy(scheme=jbfp.Scheme.TILED, block_k=32)
    want = to_numpy_tree(jax.jit(jax.grad(
        lambda a, b: (j_matmul_2d(a, b, jpol) * g).sum(),
        argnums=(0, 1)))(x, w))
    xt, wt = t(x).requires_grad_(), t(w).requires_grad_()
    (bfp_matmul_2d(xt, wt, pol) * t(g)).sum().backward()
    for got, ref in zip((xt.grad, wt.grad), want):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())
    # straight_through=False: no graph through the datapath
    out = bfp_matmul_2d(t(x).requires_grad_(), t(w),
                            pol.with_(straight_through=False))
    assert out.grad_fn is None


def test_overflow_guard_and_missing_noise_raise_as_in_repro():
    x, w = _operands(EM_CASES[0])
    with pytest.raises(ValueError, match="overflows int32"):
        bfp_matmul_2d(t(x), t(w), BFPPolicy(
            l_w=12, l_i=12, scheme=Scheme.TILED, block_k=512))
    # float weights under STOCHASTIC: the weight side has no noise (repro:
    # no key) and raises
    with pytest.raises(ValueError, match="stochastic"):
        bfp_matmul_2d(t(x), t(w), BFPPolicy(
            rounding=Rounding.STOCHASTIC), t(np.zeros_like(x)))
    with pytest.raises(ValueError, match="stochastic rounding requires"):
        j_matmul_2d(x, w, JPolicy(
            rounding=jbfp.Rounding.STOCHASTIC), jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="inconsistent"):
        bfp_matmul_2d_prequant(t(x), t(w).to(torch.int8),
                                   torch.ones(5, 10), BFPPolicy())


@pytest.fixture(scope="module")
def engine_refs():
    """repro's engine under the paper's policy requested on the kernel
    backend: it warns and runs emulated."""
    x3 = normal((2, 3, 96), seed=5)
    w = normal((96, 10), seed=6, scale=0.1)
    xc = normal((2, 9, 8, 5), seed=7)
    wc = normal((3, 3, 5, 6), seed=8, scale=0.2)
    pol = JPolicy(backend="pallas")

    def ref_fn(x3, w, xc, wc):
        return (JEG.gemm(x3, w, pol, path="emu_parity_fc"),
                JEG.conv2d(xc, wc, pol, stride=2, padding="SAME",
                           path="emu_parity_conv"),
                JEG.gemm(x3, w, JPolicy()),
                JEG.conv2d(xc, wc, JPolicy(), stride=1, padding="VALID"))

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (x3, w, xc, wc), to_numpy_tree(jax.jit(ref_fn)(x3, w, xc,
                                                             wc))


def test_engine_falls_back_to_emulated_with_a_warning(engine_refs):
    (x3, w, xc, wc), (want_g, want_c, want_g2, want_c2) = engine_refs
    pol = PAPER_DEFAULT.with_(backend="pallas")
    BK._WARNED.discard(("pallas", "emu_parity_fc"))
    BK._WARNED.discard(("pallas", "emu_parity_conv"))
    with pytest.warns(EG.BackendFallbackWarning, match="emu_parity_fc"):
        got = EG.gemm(t(x3), t(w), pol, path="emu_parity_fc")
    assert_bits_equal(got, want_g)
    with pytest.warns(EG.BackendFallbackWarning, match="emu_parity_conv"):
        got = EG.conv2d(t(xc), t(wc), pol, stride=2, padding="SAME",
                        path="emu_parity_conv")
    assert_bits_equal(got, want_c)
    # once per site: the second call is silent
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        EG.gemm(t(x3), t(w), pol, path="emu_parity_fc")
        # PAPER_DEFAULT names "emulated" itself: no downgrade, no warning
        assert_bits_equal(EG.gemm(t(x3), t(w), PAPER_DEFAULT), want_g2)
        assert_bits_equal(bfp_dot(t(x3), t(w), PAPER_DEFAULT), want_g2)
        assert_bits_equal(EG.conv2d(t(xc), t(wc), PAPER_DEFAULT,
                                    padding="VALID"), want_c2)
    with pytest.raises(EG.BackendUnsupportedError, match="strict"):
        BK.select_backend(pol, t(w), strict=True, path="emu_parity_fc")
    assert BK.select_backend(pol, t(w), path="emu_parity_fc").name == \
        "emulated"


def test_engine_passes_stochastic_noise_to_the_emulated_backend(refs):
    """``gemm(noise=)`` reaches the emulated matmul (repro: ``key=``);
    prequant weights, so only x is rounded stochastically."""
    i = [c[0] for c in PQ_CASES].index("eq4-stochastic")
    x, _ = _operands((None,) * 5 + PQ_CASES[i][5:])
    side, want, noise = refs[1][i]
    pol = BFPPolicy(rounding=Rounding.STOCHASTIC)
    got = EG.gemm(t(x), {"m": t(side["m"]), "s": t(side["s"])}, pol,
                  noise=t(noise))
    assert_bits_equal(got, want)


# F5: a contraction of length 1 (one product per output) where a zero
# mantissa meets a negative one: repro's int32 dot gives +0.0
K1_SCHEMES = [(s, l) for s in Scheme for l in (4, 8)]


def _k1_operands():
    x = normal((6, 1), seed=41)
    x[::2] = 0.0                                  # zero rows -> 0 * w
    w = -np.abs(normal((1, 5), seed=42, scale=0.1))   # negative weights
    xc = normal((2, 4, 3, 1), seed=43)
    xc[:, ::2] = 0.0
    wc = -np.abs(normal((1, 1, 1, 4), seed=44, scale=0.1))
    return x, w, xc, wc


@pytest.fixture(scope="module")
def k1_refs():
    x, w, xc, wc = _k1_operands()

    def ref_fn(x, w, xc, wc):
        out = []
        for s, l in K1_SCHEMES:
            pol = _policy(JPolicy, s, Rounding.ROUND, l,
                          1 if s is Scheme.TILED else None)
            out.append((JEG.gemm(x, w, pol), JEG.conv2d(xc, wc, pol)))
        return out

    return to_numpy_tree(jax.jit(ref_fn)(x, w, xc, wc))


@pytest.mark.parametrize("i", range(len(K1_SCHEMES)),
                         ids=[f"{s.value}-L{l}" for s, l in K1_SCHEMES])
def test_contraction_of_one_gives_positive_zeros(k1_refs, i):
    """``engine.gemm`` with K = 1 and a 1x1 conv over one channel: the
    zeros are +0.0, bit-equal to ``repro`` (F5)."""
    x, w, xc, wc = _k1_operands()
    s, l = K1_SCHEMES[i]
    pol = _policy(BFPPolicy, s, Rounding.ROUND, l,
                  1 if s is Scheme.TILED else None)
    want_g, want_c = k1_refs[i]
    got_g = EG.gemm(t(x), t(w), pol)
    got_c = EG.conv2d(t(xc), t(wc), pol)
    assert (want_g == 0).any() and not np.signbit(want_g[want_g == 0]).any()
    assert_bits_equal(got_g, want_g)
    assert_bits_equal(got_c, want_c)
