"""Port parity for the standalone block-formatting kernel and the kernel
oracles: ``repro_torch.kernels.ops.bfp_quantize`` (CPU: the kernel's
plain version) against ``repro``'s ``ops.bfp_quantize`` (its padding and
``bfp_quantize_pallas`` in interpret mode), and
``repro_torch.kernels.ref`` against ``repro.kernels.ref`` — all bit for
bit, ragged shapes, zero/inf/NaN blocks and bits > 8 included.

What ``repro`` does at the edges, found on the CPU and pinned here: a
block whose amax is not > 0 (all zero, or holding a NaN) gets exponent
-126 and is NOT zeroed (its other elements saturate against the tiny
step); a NaN element gives mantissa 0; an inf block gets exponent 128;
the kernel stores its clipped mantissa as int8 the way XLA converts,
saturating, so bits 9..12 clip to [-128, 127] while the oracle keeps
int32.  Subnormal amax blocks are held against numpy: XLA:CPU flushes
subnormals to zero.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import bfp_quantize as KQ
from repro_torch.kernels import launch_counts, ops, ref
from test_torch_util import (CONV_CASES, MM_CASES, Q_CASES, assert_bits_equal,
                             conv_inputs, mm_inputs, q_inputs, t,
                             to_numpy_tree)

@pytest.fixture(scope="module")
def quant_refs():
    """repro's wrapper (padding + the Pallas kernel in interpret mode) and
    its oracle on every case, in one compiled program."""
    xs = [q_inputs(c) for c in Q_CASES]

    def ref_fn(xs):
        out = []
        for (m, k, bk, bits), x in zip(Q_CASES, xs):
            kernel = jops.bfp_quantize(x, bits, bk, interpret=True)
            kp = -(-k // bk) * bk
            oracle = jref.bfp_quantize_ref(jnp.pad(x, ((0, 0), (0, kp - k))),
                                           bits, bk)
            out.append((kernel, oracle))
        return out

    return to_numpy_tree(jax.jit(ref_fn)(xs))


@pytest.mark.parametrize("i", range(len(Q_CASES)),
                         ids=[f"M{c[0]}K{c[1]}bk{c[2]}L{c[3]}"
                              for c in Q_CASES])
def test_bfp_quantize_matches_the_pallas_kernel(quant_refs, i):
    m, k, bk, bits = Q_CASES[i]
    (want_m, want_e), (or_m, or_e) = quant_refs[i]
    got_m, got_e = ops.bfp_quantize(t(q_inputs(Q_CASES[i])), bits, bk)
    assert tuple(got_e.shape) == (m, -(-k // bk))
    assert_bits_equal(got_m, want_m)
    assert_bits_equal(got_e, want_e)
    # the port's oracle against repro's oracle (int32 mantissas above 8)
    kp = -(-k // bk) * bk
    xp = torch.nn.functional.pad(t(q_inputs(Q_CASES[i])), (0, kp - k))
    rm, re_ = ref.bfp_quantize_ref(xp, bits, bk)
    assert_bits_equal(rm, or_m)
    assert_bits_equal(re_, or_e)
    # kernel == oracle, the oracle saturated to int8 as the kernel stores it
    assert_bits_equal(got_m, rm[:, :k].clamp(-128, 127).to(torch.int8))
    assert_bits_equal(got_e, re_)


def test_bfp_quantize_edge_rules_pinned(quant_refs):
    """The rules the docstring states, read off repro's own output."""
    (m8, e8), _ = quant_refs[0]                    # (5, 200, 32, 8)
    assert e8[0, 0] == -126 and (m8[0, :32] == 0).all()   # zero block
    assert e8[1, 0] == -126 and m8[1, 3] == 0             # NaN block
    assert set(np.abs(m8[1, :32][np.arange(32) != 3])) <= {127}
    assert e8[2, -1] == 128 and m8[2, -1] == 127          # inf block
    assert (m8[3, :32] == -127).all()
    (m12, _), (o12, _) = quant_refs[6]             # bits 12 saturates
    assert o12.dtype == np.int32 and np.abs(o12).max() > 127
    assert m12.dtype == np.int8 and m12.min() == -128 and m12.max() == 127


def test_bfp_quantize_subnormal_amax_against_numpy():
    """XLA:CPU flushes subnormal operands, so repro reads these blocks as
    zero; the kernel (and its plain version) keep IEEE subnormals: the
    exponent field of a subnormal amax is 0, so e = -127, and the step
    2^(e - (bits - 2)) is subnormal too."""
    x = np.array([[1e-40, -3e-41, 0.0, 2e-45], [1e-39, 5e-40, 0.0, 0.0]],
                 np.float32)
    got_m, got_e = ops.bfp_quantize(t(x), 8, 4)
    assert got_e.flatten().tolist() == [-127, -127]
    step = np.float32(2.0 ** -133)
    want = np.clip(np.round(x / step), -127, 127).astype(np.int8)
    assert_bits_equal(got_m, want)


def test_plain_version_rejects_bad_arguments_and_counts_no_launch():
    before = launch_counts()["bfp_quantize"]
    with pytest.raises(ValueError, match="bits"):
        KQ.bfp_quantize(torch.ones(2, 8), bits=25, bk=4)
    with pytest.raises(ValueError, match=r"\[M, K\]"):
        KQ.bfp_quantize(torch.ones(8), bits=8, bk=4)
    with pytest.raises(ValueError, match="CUDA"):
        KQ.bfp_quantize(torch.ones(2, 8, device="meta"), bits=8, bk=4)
    m, e = KQ.bfp_quantize(torch.ones(0, 8), bits=8, bk=4)
    assert m.shape == (0, 8) and e.shape == (0, 2)
    assert launch_counts()["bfp_quantize"] == before   # CPU: no kernel


def test_oracle_pow2_every_exponent():
    e = np.arange(-160, 131, dtype=np.int32)
    assert_bits_equal(ref.pow2(t(e)), jax.jit(jref.pow2)(e))


@pytest.fixture(scope="module")
def oracle_refs():
    mm = [mm_inputs(c) for c in MM_CASES]
    cv = [conv_inputs(c) for c in CONV_CASES]

    def ref_fn(mm, cv):
        out_mm = []
        for (b, k, n, bk, lb), (x, w) in zip(MM_CASES, mm):
            kp = -(-k // bk) * bk
            out_mm.append(jref.bfp_matmul_ref(
                jnp.pad(x, ((0, 0), (0, kp - k))),
                jnp.pad(w, ((0, kp - k), (0, 0))), lb, lb, bk))
        out_cv = [jref.bfp_conv2d_ref(x, w, lb, lb, bk, s, pad)
                  for (s, kk, pad, bk, lb, c), (x, w) in zip(CONV_CASES, cv)]
        return out_mm, out_cv

    return to_numpy_tree(jax.jit(ref_fn)(mm, cv))


@pytest.mark.parametrize("i", range(len(MM_CASES)))
def test_oracle_matmul_matches_repro(oracle_refs, i):
    b, k, n, bk, lb = MM_CASES[i]
    x, w = mm_inputs(MM_CASES[i])
    kp = -(-k // bk) * bk
    got = ref.bfp_matmul_ref(
        torch.nn.functional.pad(t(x), (0, kp - k)),
        torch.nn.functional.pad(t(w), (0, 0, 0, kp - k)), lb, lb, bk)
    assert_bits_equal(got, oracle_refs[0][i])


@pytest.mark.parametrize("i", range(len(CONV_CASES)))
def test_oracle_conv_matches_repro(oracle_refs, i):
    s, kk, pad, bk, lb, c = CONV_CASES[i]
    x, w = conv_inputs(CONV_CASES[i])
    got = ref.bfp_conv2d_ref(t(x), t(w), lb, lb, bk, s, pad)
    assert_bits_equal(got, oracle_refs[1][i])


def test_oracle_checks_its_shapes():
    with pytest.raises(ValueError, match="block_k"):
        ref.bfp_quantize_ref(torch.ones(2, 10), 8, 4)
    with pytest.raises(ValueError, match="block_k"):
        ref.bfp_matmul_ref(torch.ones(2, 10), torch.ones(10, 3), 8, 8, 4)
    with pytest.raises(ValueError, match="padding"):
        ref.bfp_conv2d_ref(torch.ones(1, 4, 4, 2), torch.ones(3, 3, 2, 2),
                           8, 8, 2, 1, "FULL")
