"""``repro_torch.core.nsr`` against ``repro.core.nsr`` on the same arrays.

Every public function is compared on numpy inputs made from fixed seeds:
at L 4 to 10, on EQ4 and TILED, on heavy-tailed activations, on a
matrix with an all-zero block and on all-zero matrices (the
``finfo(float32).tiny`` guards: a zero signal gives -inf dB, a zero
noise +inf dB, never NaN).  The quantizers are bit-equal between the two
packages, but the energies are float32 sums in another order (PyTorch's
reductions against XLA's), so values agree to 1e-5 relative, and values
in dB to 1e-3 dB; non-finite values must be equal.  The eq. 16
additivity check of ``repro``'s property test (R4: its hypothesis case
fails there on its own) runs here at fixed seeds.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import nsr as jnsr
from repro.core.bfp import Scheme as JScheme
from repro.core.policy import BFPPolicy as JBFPPolicy
from repro_torch.core import nsr
from repro_torch.core.bfp import Scheme
from repro_torch.core.policy import BFPPolicy
from test_torch_util import normal, rng, t

#: (L, scheme): L 4 to 10, each on EQ4 and on TILED (block 32)
POLICIES = [(bits, scheme) for bits in range(4, 11)
            for scheme in ("eq4", "tiled")]


def _pols(bits, scheme):
    kw = dict(l_w=bits, l_i=bits, straight_through=False)
    if scheme == "tiled":
        return (BFPPolicy(scheme=Scheme.TILED, block_k=32, **kw),
                JBFPPolicy(scheme=JScheme.TILED, block_k=32, **kw))
    return BFPPolicy(**kw), JBFPPolicy(**kw)


def acts(shape, seed, spread=1.0):
    """Heavy-tailed activations: normal * exp(spread * normal)."""
    g = rng(seed)
    return (g.standard_normal(shape) *
            np.exp(spread * g.standard_normal(shape))).astype(np.float32)


def inputs():
    """x [64, 128] (one all-zero 32-block in row 0), w [128, 64] (one
    all-zero column), g [64, 64]."""
    x = acts((64, 128), seed=1)
    x[0, :32] = 0.0
    w = normal((128, 64), seed=2, scale=0.1)
    w[:, 5] = 0.0
    return x, w, normal((64, 64), seed=3)


def close(got, want, db=False):
    got = float(got)
    want = float(np.asarray(want))
    if not np.isfinite(want):
        assert got == want, (got, want)
    elif db:
        assert abs(got - want) < 1e-3, (got, want)
    else:
        assert abs(got - want) <= 1e-5 * abs(want) + 1e-30, (got, want)


@pytest.fixture(scope="module")
def refs():
    """``repro``'s values for every policy case, in one compiled
    program."""
    x, w, g = inputs()
    zero = np.zeros((16, 32), np.float32)

    def ref_fn(x, w, g, zero):
        out = []
        for bits, scheme in POLICIES:
            p = _pols(bits, scheme)[1]
            out.append({
                "pred_i": jnsr.predict_matrix_snr(x, bits, "i", p),
                "pred_w": jnsr.predict_matrix_snr(w, bits, "w", p),
                "meas_i": jnsr.measure_matrix_snr(x, bits, "i", p),
                "meas_w": jnsr.measure_matrix_snr(w, bits, "w", p),
                "pred_zero": jnsr.predict_matrix_snr(zero, bits, "i", p),
                "gemm_ub": jnsr.gemm_nsr_upper_bound(x, w, p),
                "gemm_ub_zero": jnsr.gemm_nsr_upper_bound(zero, zero.T, p),
                "dx_ub": jnsr.grad_dx_nsr_upper_bound(g, w, p),
                "dw_ub": jnsr.grad_dw_nsr_upper_bound(x, g, p),
                "noise_var": jnsr.quantization_noise_var(
                    jax.numpy.arange(-130, 10, dtype=jax.numpy.int32), bits),
            })
        return out
    return (x, w, g, zero), jax.tree_util.tree_map(
        np.asarray, jax.jit(ref_fn)(x, w, g, zero))


@pytest.mark.parametrize("i", range(len(POLICIES)),
                         ids=[f"L{b}-{s}" for b, s in POLICIES])
def test_matrix_snrs_and_bounds_match_repro(refs, i):
    (x, w, g, zero), want = refs[0], refs[1][i]
    bits, scheme = POLICIES[i]
    p = _pols(bits, scheme)[0]
    x, w, g, zero = t(x), t(w), t(g), t(zero)
    close(nsr.predict_matrix_snr(x, bits, "i", p), want["pred_i"], db=True)
    close(nsr.predict_matrix_snr(w, bits, "w", p), want["pred_w"], db=True)
    close(nsr.measure_matrix_snr(x, bits, "i", p), want["meas_i"], db=True)
    close(nsr.measure_matrix_snr(w, bits, "w", p), want["meas_w"], db=True)
    got = nsr.predict_matrix_snr(zero, bits, "i", p)
    assert float(got) == float("-inf")            # zero signal: -inf dB
    close(got, want["pred_zero"], db=True)
    close(nsr.gemm_nsr_upper_bound(x, w, p), want["gemm_ub"])
    close(nsr.gemm_nsr_upper_bound(zero, zero.t(), p), want["gemm_ub_zero"])
    close(nsr.grad_dx_nsr_upper_bound(g, w, p), want["dx_ub"])
    close(nsr.grad_dw_nsr_upper_bound(x, g, p), want["dw_ub"])
    var = nsr.quantization_noise_var(torch.arange(-130, 10,
                                                  dtype=torch.int32), bits)
    # XLA:CPU flushes the subnormal steps of the lowest exponents to 0
    normal_steps = slice(130 - 126 + bits - 2, None)
    np.testing.assert_allclose(var.numpy()[normal_steps],
                               want["noise_var"][normal_steps], rtol=1e-5)
    assert float(nsr.matrix_nsr_upper_bound(32, bits)) == \
        jnsr.matrix_nsr_upper_bound(32, bits)


def test_scalar_conversions_and_guards_match_repro():
    """snr_db (incl. a zero signal and a zero noise), the dB/NSR
    conversions and eq. 18-20, against ``repro``."""
    y = acts((128, 64), seed=5)
    noisy = y + 0.01 * normal(y.shape, seed=6)
    snrs = np.array([-3.0, 0.0, 17.5, 42.25, 80.0], np.float32)
    nsrs = np.array([0.0, 1e-45, 1e-9, 0.25, 3.0], np.float32)
    cases = [
        (nsr.snr_db(t(y), t(noisy)), jnsr.snr_db(y, noisy), True),
        (nsr.snr_db(t(y), t(y)), jnsr.snr_db(y, y), True),            # +inf
        (nsr.snr_db(t(0 * y), t(noisy)), jnsr.snr_db(0 * y, noisy), True),
        (nsr.snr_db(t(0 * y), t(0 * y)), jnsr.snr_db(0 * y, 0 * y), True),
        (nsr.single_layer_output_snr(30.0, 40.0),
         jnsr.single_layer_output_snr(30.0, 40.0), True),
        (nsr.chain_input_nsr(0.01, 0.02), jnsr.chain_input_nsr(0.01, 0.02),
         False)]
    cases += [(nsr.nsr_from_snr_db(float(s)), jnsr.nsr_from_snr_db(s), False)
              for s in snrs]
    cases += [(nsr.snr_db_from_nsr(float(n)), jnsr.snr_db_from_nsr(n), True)
              for n in nsrs]
    for got, want, db in cases:
        close(got, want, db=db)
    assert float(nsr.snr_db(t(y), t(y))) == float("inf")
    assert float(nsr.snr_db(t(0 * y), t(0 * y))) == float("-inf")
    assert np.isfinite(float(nsr.snr_db_from_nsr(0.0)))   # the tiny guard


def _chain_rows(reps):
    return [dataclasses.astuple(r) for r in reps]


def _assert_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(_chain_rows(got), _chain_rows(want)):
        assert g[0] == w[0]
        for a, b in zip(g[1:], w[1:]):
            close(a, b, db=True)


@pytest.mark.parametrize("scheme", ["eq4", "tiled"])
def test_analyze_gemm_chain_matches_repro(scheme):
    """A 3-layer GEMM+ReLU chain, float and BFP, every row field."""
    x = acts((64, 128), seed=11)
    ws = [normal((128, 128), seed=12 + i, scale=0.08) for i in range(3)]
    p, jp = _pols(8, scheme)
    got = nsr.analyze_gemm_chain(t(x), [t(w) for w in ws], p,
                                 names=["a", "b", "c"])
    _assert_rows(got, jnsr.analyze_gemm_chain(x, ws, jp,
                                              names=["a", "b", "c"]))
    assert isinstance(got[0], nsr.LayerSNRReport)
    for r in got:        # the paper's 8.9 dB envelope
        assert abs(r.snr_output_measured - r.snr_output_multi) < 8.9


@pytest.mark.parametrize("bits", range(5, 11))
def test_eta_additivity_at_fixed_seeds(bits):
    """Eq. 16 (eta_O ~= eta_I + eta_W), ``repro``'s property check at
    fixed seeds, with the rows held against ``repro``'s."""
    for seed in range(3):
        x = acts((256, 128), seed=100 * bits + seed)
        w = normal((128, 64), seed=100 * bits + seed + 50, scale=0.1)
        p, jp = _pols(bits, "eq4")
        got = nsr.analyze_gemm_chain(t(x), [t(w)], p)
        _assert_rows(got, jnsr.analyze_gemm_chain(x, [w], jp))
        r = got[0]
        ratio = 10 ** (-r.snr_output_measured / 10) / \
            10 ** (-r.snr_output_single / 10)
        assert 0.15 < ratio < 6.0, (bits, seed, ratio)
