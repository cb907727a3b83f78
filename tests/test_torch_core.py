"""Port parity: repro_torch.core against repro.core (bit-exact)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bfp as jbfp
from repro.core import conv_utils as jcu
from repro.core import prequant as jpq
from repro.core.policy import PALLAS_TILED as J_PALLAS_TILED
from repro.core.policy import PAPER_DEFAULT as J_PAPER_DEFAULT
from repro.core.policy import TPU_TILED as J_TPU_TILED
from repro.engine import PolicyMap as JPolicyMap
from repro_torch.convert import params_from_numpy
from repro_torch.core import bfp
from repro_torch.core import conv_utils as cu
from repro_torch.core import prequant as pq
from repro_torch.core.policy import (PALLAS_TILED, PAPER_DEFAULT, TPU_TILED,
                                     BFPPolicy)
from repro_torch.engine import PolicyMap
from test_torch_util import assert_bits_equal, normal, t, to_numpy_tree


def test_pow2_every_exponent():
    e = np.arange(-160, 131, dtype=np.int32)
    assert_bits_equal(bfp.pow2(t(e)), jax.jit(jbfp.pow2)(e))


def test_block_exponent_zero_and_normal_blocks():
    x = np.zeros((3, 6), np.float32)
    x[1] = normal(6, seed=1) * 1e3
    x[2] = [0, 0, 0, 0, 0, -np.float32(2.0 ** -126)]  # smallest normal
    assert_bits_equal(bfp.block_exponent(t(x), (1,)),
                      jax.jit(lambda a: jbfp.block_exponent(a, (1,)))(x))


def test_block_exponent_subnormal_amax_is_exact():
    """frexp gives a subnormal amax its true exponent (IEEE, as the
    reference's docstring defines it).  XLA:CPU flushes subnormal
    operands to zero, so there ``repro`` itself reads such a block as an
    all-zero block (-126); the oracle here is numpy's exact frexp."""
    x = np.array([[1e-40, -3e-41, 0.0, 2e-45]], np.float32)
    want = np.frexp(np.abs(x).max(axis=1, keepdims=True))[1] - 1
    got = bfp.block_exponent(t(x), (1,))
    assert_bits_equal(got, want.astype(np.int32))
    assert got.item() == -133
    assert np.asarray(jbfp.block_exponent(jnp.asarray(x), (1,))).item() \
        in (-133, -126)                  # -126 where XLA flushes to zero


SCHEMES = list(bfp.Scheme)
ROUNDINGS = list(bfp.Rounding)
_W = normal((8, 32), seed=2)                       # W [M, K]
_W[3, :16] = 0.0                                   # an all-zero TILED block
_OPERANDS = {"w": _W, "i": np.ascontiguousarray(_W.T)}   # I [K, N]


def _noise_shape(scheme, op):
    # the reference draws its noise in the shape it quantizes (TILED:
    # per-block 3-D); the same numbers are handed to the port
    if scheme is bfp.Scheme.TILED:
        return (8, 2, 16) if op == "w" else (2, 16, 8)
    return _OPERANDS[op].shape


@pytest.fixture(scope="module")
def quant_refs():
    """Every scheme x rounding x operand of the reference, in one compiled
    program (one XLA compile instead of one per case)."""
    key = jax.random.PRNGKey(7)

    def ref_fn(ops, key):
        out = {}
        for sc in SCHEMES:
            for rd in ROUNDINGS:
                for op, x in ops.items():
                    blk = jbfp.bfp_quantize_matrix(
                        x, 6, op, jbfp.Scheme(sc.value),
                        16, jbfp.Rounding(rd.value), key)
                    out[sc.value, rd.value, op] = (
                        blk.mantissa, blk.exponent, blk.dequantize(),
                        jax.random.uniform(key, _noise_shape(sc, op)))
        return out

    return to_numpy_tree(jax.jit(ref_fn)(_OPERANDS, key))


@pytest.mark.parametrize("rounding", ROUNDINGS, ids=lambda r: r.value)
@pytest.mark.parametrize("scheme", SCHEMES, ids=lambda s: s.value)
def test_bfp_quantize_matrix_every_scheme_and_rounding(quant_refs, scheme,
                                                       rounding):
    for op, x in _OPERANDS.items():
        m, e, dq, noise = quant_refs[scheme.value, rounding.value, op]
        got = bfp.bfp_quantize_matrix(
            t(x), 6, op, scheme, 16, rounding,
            t(noise.reshape(x.shape))
            if rounding is bfp.Rounding.STOCHASTIC else None)
        assert_bits_equal(got.mantissa, m)
        assert_bits_equal(got.exponent, e)
        assert_bits_equal(got.dequantize(), dq)


_WIDTHS = [2, 8, 12, 16, 24]


@pytest.fixture(scope="module")
def width_refs():
    def ref_fn(xs):
        out = {}
        for bits in _WIDTHS:
            blk = jbfp.quantize(xs[bits], bits, (1, 2))
            out[bits] = (blk.mantissa, blk.exponent, jbfp.dequantize(blk))
        return out
    return to_numpy_tree(jax.jit(ref_fn)(
        {b: normal((5, 7, 3), seed=b) for b in _WIDTHS}))


@pytest.mark.parametrize("bits", _WIDTHS)
def test_quantize_widths_and_dtypes(width_refs, bits):
    got = bfp.quantize(t(normal((5, 7, 3), seed=bits)), bits, (1, 2))
    m, e, dq = width_refs[bits]
    assert_bits_equal(got.mantissa, m)
    assert_bits_equal(got.exponent, e)
    assert_bits_equal(bfp.dequantize(got), dq)


def test_quantize_rejects_bad_width_and_missing_noise():
    with pytest.raises(ValueError, match="bits"):
        bfp.quantize(torch.ones(3), 25, (0,))
    with pytest.raises(ValueError, match="stochastic"):
        bfp.quantize(torch.ones(3), 8, (0,), bfp.Rounding.STOCHASTIC)


def test_accounting_helpers():
    for scheme in SCHEMES:
        j = jbfp.Scheme(scheme.value)
        assert bfp.num_block_exponents(scheme, 64, 300, 32, 128) == \
            jbfp.num_block_exponents(j, 64, 300, 32, 128)
    assert bfp.average_bits_per_element(8, 8, 16) == \
        jbfp.average_bits_per_element(8, 8, 16)
    for k in (1, 2, 3, 128, 4096, 25088):
        assert bfp.accumulator_bits(8, 8, k) == jbfp.accumulator_bits(8, 8, k)
    assert bfp.max_safe_k(8, 8) == jbfp.max_safe_k(8, 8)


def _fields(p):
    d = dataclasses.asdict(p)
    d["scheme"], d["rounding"] = p.scheme.value, p.rounding.value
    return d


def test_policies_match_reference():
    for mine, ref in ((PAPER_DEFAULT, J_PAPER_DEFAULT),
                      (TPU_TILED, J_TPU_TILED),
                      (PALLAS_TILED, J_PALLAS_TILED)):
        assert _fields(mine) == _fields(ref)
        assert mine.backend_name == ref.backend_name
    with pytest.raises(ValueError):
        BFPPolicy(l_w=1)


def test_policy_map_json_from_reference_loads_unchanged():
    jpm = JPolicyMap.of(("^conv1_1$", None),
                        ("^fc", J_PALLAS_TILED.with_(l_w=6, l_i=6)),
                        default=J_PALLAS_TILED)
    pm = PolicyMap.from_dict(jpm.to_dict())
    assert pm.to_dict() == jpm.to_dict()
    for path in ("conv1_1", "conv2_2", "fc6", None):
        ref = jpm.resolve(path)
        got = pm.resolve(path)
        assert (got is None) == (ref is None)
        if got is not None:
            assert (got.l_w, got.l_i, got.block_k, got.backend_name) == \
                (ref.l_w, ref.l_i, ref.block_k, ref.backend_name)


_GEOMS = [(9, 9, 3, 1, "SAME"), (10, 7, 3, 2, "SAME"), (11, 11, 7, 2, "SAME"),
          (8, 8, 1, 1, "VALID"), (12, 9, 3, 2, "VALID"), (5, 5, 5, 3, "SAME")]


def _geom_input(h, w):
    return normal((2, h, w, 3), seed=h * w)


@pytest.fixture(scope="module")
def im2col_refs():
    def ref_fn(xs):
        return [jcu.im2col(x, k, k, s, p)[0]
                for x, (_, _, k, s, p) in zip(xs, _GEOMS)]
    return to_numpy_tree(jax.jit(ref_fn)(
        [_geom_input(h, w) for h, w, *_ in _GEOMS]))


@pytest.mark.parametrize("case", range(len(_GEOMS)))
def test_conv_geometry_and_im2col(im2col_refs, case):
    h, w, k, stride, padding = _GEOMS[case]
    geom = cu.conv_geometry(h, w, k, k, stride, padding)
    assert geom == jcu.conv_geometry(h, w, k, k, stride, padding)
    cols, shp = cu.im2col(t(_geom_input(h, w)), k, k, stride, padding)
    assert shp == (2,) + geom[:2]
    assert_bits_equal(cols, im2col_refs[case])
    wt = normal((k, k, 3, 4), seed=1)
    assert_bits_equal(cu.conv_weight_matrix(t(wt)), wt.reshape(-1, 4))


def test_conv_geometry_errors():
    with pytest.raises(ValueError, match="VALID"):
        cu.conv_geometry(2, 2, 3, 3, 1, "VALID")
    with pytest.raises(ValueError, match="padding"):
        cu.conv_geometry(4, 4, 3, 3, 1, "FULL")


_PQ_BLOCKS = [8, 16, None]
_PQ_W = normal((2, 48, 5), seed=3)                 # stacked [L, K, N]
_PQ_WC = normal((3, 3, 16, 6), seed=4)             # K = 144
_PQ_X = normal((2, 3, 48), seed=5)


def _pq_policies(bk):
    return (TPU_TILED.with_(block_k=bk, l_w=7, l_i=6),
            J_TPU_TILED.with_(block_k=bk, l_w=7, l_i=6))


@pytest.fixture(scope="module")
def prequant_refs():
    def ref_fn(w, wc, x):
        out = {}
        for bk in _PQ_BLOCKS:
            jpol = _pq_policies(bk)[1]
            leaf = jpq.prequant_leaf(w, jpol)
            act = jpq.prequant_act(x, jpol)
            out[str(bk)] = (leaf, jpq.dequantize_prequant(leaf),
                            jpq.prequant_conv_leaf(wc, jpol), act,
                            jpq.dequantize_act(act))
        return out
    return to_numpy_tree(jax.jit(ref_fn)(_PQ_W, _PQ_WC, _PQ_X))


@pytest.mark.parametrize("bk", _PQ_BLOCKS)
def test_prequant_leaf_conv_leaf_and_act(prequant_refs, bk):
    pol = _pq_policies(bk)[0]
    leaf, dq, conv, act, dqa = prequant_refs[str(bk)]
    got = pq.prequant_leaf(t(_PQ_W), pol)
    assert_bits_equal(got["m"], leaf["m"])
    assert_bits_equal(got["s"], leaf["s"])
    assert_bits_equal(pq.dequantize_prequant(got), dq)
    got = pq.prequant_conv_leaf(t(_PQ_WC), pol)
    assert_bits_equal(got["m"], conv["m"])
    assert_bits_equal(got["s"], conv["s"])
    got = pq.prequant_act(t(_PQ_X), pol)
    assert_bits_equal(got["m"], act["m"])
    assert_bits_equal(got["s"], act["s"])
    assert pq.act_block(got) == jpq.act_block(act)
    assert_bits_equal(pq.dequantize_act(got), dqa)


def test_prequant_leaves_stay_float_when_block_does_not_divide_k():
    pol, jpol = TPU_TILED.with_(block_k=128), J_TPU_TILED.with_(block_k=128)
    w = normal((27, 4))
    assert not pq.is_prequant(pq.prequant_leaf(t(w), pol))
    assert not jpq.is_prequant(jpq.prequant_leaf(jnp.asarray(w), jpol))
    wc = normal((3, 3, 3, 4))
    assert pq.prequant_conv_leaf(t(wc), pol).shape == (3, 3, 3, 4)
    with pytest.raises(ValueError, match="block_k"):
        pq.prequant_act(t(w.T), pol)


def test_quantize_cnn_param_tree_paths_and_leaves():
    g = normal((3, 3, 16, 16), seed=6)               # K = 144
    tree = {"stem": {"conv": {"w": g}, "bn": {"gamma": np.ones(16, np.float32)}},
            "blocks": [{"c1": {"w": normal((3, 3, 16, 16), seed=7),
                               "b": np.zeros(16, np.float32)}}],
            "fc": {"w": normal((32, 10), seed=8), "b": np.zeros(10, np.float32)}}
    jpm = JPolicyMap.of(("^fc$", None), default=J_TPU_TILED.with_(block_k=16))
    pm = PolicyMap.from_dict(jpm.to_dict())
    ref = to_numpy_tree(jax.jit(
        lambda tr: jpq.quantize_cnn_param_tree(tr, jpm))(tree))
    got = pq.quantize_cnn_param_tree(
        params_from_numpy(tree, "cpu"), pm)
    assert pq.cnn_rule_path(tree, ["stem", "conv", "w"]) == \
        jpq.cnn_rule_path(tree, ["stem", "conv", "w"]) == "stem"
    assert pq.cnn_rule_path(tree, ["blocks", "0", "c1", "w"]) == "blocks/0/c1"
    for path in (("stem", "conv"), ("blocks", 0, "c1")):
        g_node, r_node = got, ref
        for p in path:
            g_node, r_node = g_node[p], r_node[p]
        assert_bits_equal(g_node["w"]["m"], r_node["w"]["m"])
        assert_bits_equal(g_node["w"]["s"], r_node["w"]["s"])
    assert not pq.is_prequant(got["fc"]["w"])       # pinned float by rule
    assert pq.detect_tree_kind(tree) == jpq.detect_tree_kind(tree) == "cnn"
    assert pq.detect_tree_kind({"embed": 1}) == "lm"
