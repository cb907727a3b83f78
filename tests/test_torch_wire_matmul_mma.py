"""The x-prequant matmul (wire-format x, float w) as the int8 mma core's
route computes it.

On the card ``bfp_matmul_xprequant`` runs the x-prequant conv's route
over x viewed as ``[1, B, 1, K]`` (steps ``[1, B, 1, K // bk]``) and w
as ``[1, 1, K, N]``: the weight format pass (``bfp_conv2d_wformat``, the
patch pass's weight blocks alone) writes the int8 ``[K, N]`` + steps
``[K // bk, N]`` sidecar once per call, the core runs the wire matmul
(``bfp_matmul_xwprequant_plain`` is its contract) and, with
``out_bits``, the output format pass (the activation format pass over
``[1, B, 1, N]``) requantizes the f32 output.  Here that composition of
plain versions is held bit-equal to ``bfp_matmul_xprequant_plain`` (the
tile kernel's contract) at out_bits 3/6/8, out_block 4-128 and blocks
32/128/512, with inf and NaN wire steps, a zero block and an inf weight,
and against ``repro``'s ``bfp_matmul_xprequant_pallas`` (interpret mode,
through its ops wrapper) on normal-range data.  The row-block helper the
wrapper uses past 2^31 elements is checked on the CPU.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import prequant as jpq
from repro.core.policy import TPU_TILED as J_TPU_TILED
from repro.kernels import ops as jops
from repro_torch import kernels as K
from repro_torch.core.policy import TPU_TILED
from repro_torch.core.prequant import prequant_act
from repro_torch.kernels import _build, _mma
from repro_torch.kernels import bfp_conv as KC
from repro_torch.kernels import bfp_matmul as KM
from test_torch_util import assert_bits_equal, normal, t, to_numpy_tree

# (B, K, N, bk, L_W, out_bits, out_block): ragged B, N not a multiple of
# 128, blocks 32 / 128 / 512, out_block 4 .. 128
CASES = [(5, 256, 64, 32, 8, 6, 4), (17, 512, 96, 128, 4, 3, 32),
         (3, 1024, 128, 512, 8, 8, 128), (8, 384, 200, 128, 6, 8, 8),
         (1, 512, 44, 32, 8, 6, 4)]
IDS = [f"B{c[0]}-K{c[1]}-N{c[2]}-bk{c[3]}-out{c[5]}x{c[6]}" for c in CASES]


def _inputs(case, hazards):
    """Wire x (the activation format pass's rules, L 8) and float w.  With
    ``hazards``: an all-zero x block, wire steps that are inf and NaN, a
    subnormal wire step and an inf weight."""
    b, k, n, bk, *_ = case
    x = t(normal((b, k), seed=k + n, scale=2.0))
    w = t(normal((k, n), seed=n + bk, scale=0.05))
    if hazards:
        x[0, :bk] = 0.0
        w[k // 3, 1] = float("inf")
    xm, xs = KC.bfp_conv2d_xformat_plain(x.reshape(1, b, 1, k), 8, bk)
    xm, xs = xm.reshape(b, k), xs.reshape(b, k // bk)
    if hazards:
        xs[0, -1] = float("inf")
        xs[-1, 0] = float("nan")
        if b > 2:
            xs[1, 0] = 1e-40
    return xm, xs, w


def _route(case, xm, xs, w, epilogue):
    """The core's route as plain versions: the weight pass, the wire
    matmul (f32) and, with the epilogue, the output pass over
    [1, B, 1, N]."""
    b, k, n, bk, lw, ob_bits, ob = case
    wm, ws = KC.bfp_conv2d_wformat_plain(w.reshape(1, 1, k, n), lw, bk)
    assert wm.shape == (k, n) and wm.dtype == torch.int8
    assert ws.shape == (k // bk, n)
    f32 = KM.bfp_matmul_xwprequant_plain(xm, xs, wm, ws, 8, 8, bk)
    if not epilogue:
        return f32
    m, s = KC.bfp_conv2d_xformat_plain(f32.reshape(1, b, 1, n), ob_bits, ob)
    return m.reshape(b, n), s.reshape(b, n // ob)


def _equal(got, want):
    if not isinstance(want, tuple):
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        assert_bits_equal(g, w.numpy())


@pytest.mark.parametrize("epilogue", [False, True], ids=["f32", "epi"])
@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_weight_pass_then_wire_matmul_equals_the_xprequant_matmul(i,
                                                                  epilogue):
    case = CASES[i]
    b, k, n, bk, lw, ob_bits, ob = case
    xm, xs, w = _inputs(case, hazards=True)
    epi = (ob_bits, ob) if epilogue else (None, None)
    want = KM.bfp_matmul_xprequant_plain(xm, xs, w, 8, lw, bk, *epi)
    _equal(_route(case, xm, xs, w, epilogue), want)
    # the wire matmul with the epilogue fused equals the output pass
    wm, ws = KC.bfp_conv2d_wformat_plain(w.reshape(1, 1, k, n), lw, bk)
    _equal(KM.bfp_matmul_xwprequant_plain(xm, xs, wm, ws, 8, 8, bk, *epi),
           want)
    # the hazards reach the output (an inf or NaN step, an inf weight)
    f32 = KM.bfp_matmul_xprequant_plain(xm, xs, w, 8, lw, bk)
    assert not bool(torch.isfinite(f32).all())


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_weight_pass_is_the_patch_pass_weight_half(i):
    """The matmul's weight blocks (per (K-tile, column)) are the patch
    format pass's weight blocks of the 1x1 conv over [1, B, 1, K]."""
    b, k, n, bk, lw, *_ = CASES[i]
    _, _, w = _inputs(CASES[i], hazards=True)
    x = t(normal((1, b, 1, k), seed=3))
    want = KC.bfp_conv2d_pformat_plain(x, w.reshape(1, 1, k, n), lw, lw,
                                       bk, 1, "VALID")[2:]
    _equal(KC.bfp_conv2d_wformat_plain(w.reshape(1, 1, k, n), lw, bk), want)


# -- against repro, on normal-range data (XLA:CPU flushes subnormals) -----

ORACLE = [(4, 256, 64, 128, 8, 6, 32), (3, 96, 48, 32, 4, 8, 16),
          (2, 512, 128, 512, 8, 3, 4)]


@pytest.fixture(scope="module")
def refs():
    """``repro``'s wire x and its x-prequant Pallas matmul (interpret mode,
    through ``ops.bfp_matmul`` on the wire dict) with and without the
    case's out_policy, in one compiled program."""
    def ref_fn(inputs):
        out = []
        for (x, w), (b, k, n, bk, lw, ob_bits, ob) in zip(inputs, ORACLE):
            pol = J_TPU_TILED.with_(block_k=bk, l_i=8, l_w=lw,
                                    straight_through=False)
            opol = J_TPU_TILED.with_(block_k=ob, l_i=ob_bits,
                                     straight_through=False)
            xq = jpq.prequant_act(x, pol)
            out.append((xq, jops.bfp_matmul(xq, w, pol, interpret=True),
                        jops.bfp_matmul(xq, w, pol, interpret=True,
                                        out_policy=opol)))
        return out
    inputs = [(normal((c[0], c[1]), seed=c[1], scale=2.0),
               normal((c[1], c[2]), seed=c[2], scale=0.05)) for c in ORACLE]
    return inputs, to_numpy_tree(jax.jit(ref_fn)(inputs))


@pytest.mark.parametrize("i", range(len(ORACLE)))
def test_route_matches_the_pallas_xprequant_matmul(refs, i):
    case = ORACLE[i]
    b, k, n, bk, lw, ob_bits, ob = case
    (x, w), (xq_want, f32_want, q_want) = refs[0][i], refs[1][i]
    xq = prequant_act(t(x), TPU_TILED.with_(block_k=bk, l_i=8,
                                            straight_through=False))
    assert_bits_equal(xq["m"], xq_want["m"])
    assert_bits_equal(xq["s"], xq_want["s"])
    f32 = _route(case, xq["m"], xq["s"], t(w), epilogue=False)
    assert_bits_equal(f32, f32_want)
    m, s = _route(case, xq["m"], xq["s"], t(w), epilogue=True)
    assert bool(torch.isfinite(s).all())
    assert_bits_equal(m, q_want["m"])
    assert_bits_equal(s, q_want["s"])


def test_cpu_xprequant_takes_the_plain_version(monkeypatch):
    """On the CPU the wrapper builds nothing and counts no launch, at a
    shape and policy whose card route is the mma core."""
    def no_build(name):
        raise AssertionError("a CPU call must not build or load a kernel")
    monkeypatch.setattr(_build, "load", no_build)
    case = CASES[1]
    b, k, n, bk, lw, ob_bits, ob = case
    assert KM.matmul_core(False, bk, k, n, 8, lw, ob_bits, ob,
                          wire_x=True) == "mma"
    xm, xs, w = _inputs(case, hazards=False)
    K.reset_launch_counts()
    got = KM.bfp_matmul_xprequant(xm, xs, w, l_i=8, l_w=lw, bk=bk,
                                  out_bits=ob_bits, out_block=ob)
    _equal(got, KM.bfp_matmul_xprequant_plain(xm, xs, w, 8, lw, bk, ob_bits,
                                              ob))
    assert not any(K.launch_counts().values())
    assert K.launch_counts()["bfp_matmul_wformat"] == 0


@pytest.mark.parametrize("out_bits", [None, 8])
def test_row_blocks_join_in_order_and_count_the_layer_once(out_bits):
    """``_mma._by_rows``, the cut the wrappers make past 2^31 elements:
    every row once, in order, and only the first block is the layer's."""
    seen = []

    def launch(r0, r1, first):
        seen.append((r0, r1, first))
        rows = torch.arange(r0, r1, dtype=torch.float32).reshape(-1, 1)
        return rows if out_bits is None else (rows.to(torch.int8), rows)

    out = _mma._by_rows(launch, 10, 4, out_bits)
    assert seen == [(0, 4, True), (4, 8, False), (8, 10, False)]
    for part in ((out,) if out_bits is None else out):
        assert part.reshape(-1).tolist() == list(range(10))
