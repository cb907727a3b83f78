"""The xw-prequant matmul (both operands on the wire) as the int8 mma
core's route computes it.

On the card ``bfp_matmul_xwprequant`` runs the xw-prequant conv's route
over x viewed as ``[1, B, 1, K]`` (steps ``[1, B, 1, K // bk]``) and the
int8 weight as ``[1, 1, K, N]`` with its sidecar ``[K // bk, N]`` as it
is: no format pass, the core, and with ``out_bits`` the output format
pass (the activation format pass over ``[1, B, 1, N]``).  Here that
composition of plain versions is held bit-equal to
``bfp_matmul_xwprequant_plain`` (the tile kernel's contract, and what
the card tests compare the kernel with) with inf, NaN and subnormal wire
steps, a zero block and an inf weight step; and the wrapper on the CPU
to ``repro``'s ``bfp_matmul_xwprequant_pallas`` (interpret mode, through
its ops wrapper) on normal-range data at blocks 32, 128 and 512,
``out_bits`` None, 3, 6 and 8 at out_block 4 to 128, and M 1, 8 and 17.
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
from repro_torch.core.prequant import prequant_act, prequant_leaf
from repro_torch.kernels import _build
from repro_torch.kernels import bfp_conv as KC
from repro_torch.kernels import bfp_matmul as KM
from test_torch_util import assert_bits_equal, normal, t, to_numpy_tree

# (B, K, N, bk, L_W, out_bits, out_block): M 1, 8 and 17, blocks 32, 128
# and 512, out_bits 3, 6 and 8 (each case also f32 out) at out_block 4 to
# 128, N not a multiple of 128
ORACLE = [(8, 512, 128, 32, 8, 6, 4), (17, 1024, 256, 128, 6, 3, 32),
          (1, 1024, 64, 512, 8, 8, 16), (8, 2048, 256, 128, 8, 8, 128),
          (17, 256, 96, 32, 4, 8, 8), (1, 512, 200, 512, 8, 6, 8)]
IDS = [f"B{c[0]}-K{c[1]}-N{c[2]}-bk{c[3]}-out{c[5]}x{c[6]}" for c in ORACLE]


def _pol(bk, l_w):
    return TPU_TILED.with_(block_k=bk, l_i=8, l_w=l_w, straight_through=False)


def _jpol(bk, l_w):
    return J_TPU_TILED.with_(block_k=bk, l_i=8, l_w=l_w,
                             straight_through=False)


@pytest.fixture(scope="module")
def refs():
    """``repro``'s wire x, prequant weight and xw-prequant Pallas matmul
    (interpret mode, through ``ops.bfp_matmul_prequant`` on the wire
    dict) with and without the case's out_policy, in one compiled
    program."""
    def ref_fn(inputs):
        out = []
        for (x, w), (b, k, n, bk, lw, ob_bits, ob) in zip(inputs, ORACLE):
            pol = _jpol(bk, lw)
            opol = J_TPU_TILED.with_(block_k=ob, l_i=ob_bits,
                                     straight_through=False)
            xq, wq = jpq.prequant_act(x, pol), jpq.prequant_leaf(w, pol)
            out.append((xq, wq,
                        jops.bfp_matmul_prequant(xq, wq["m"], wq["s"], pol,
                                                 interpret=True),
                        jops.bfp_matmul_prequant(xq, wq["m"], wq["s"], pol,
                                                 interpret=True,
                                                 out_policy=opol)))
        return out
    inputs = [(normal((c[0], c[1]), seed=c[1] + c[0], scale=2.0),
               normal((c[1], c[2]), seed=c[2], scale=0.05)) for c in ORACLE]
    return inputs, to_numpy_tree(jax.jit(ref_fn)(inputs))


@pytest.mark.parametrize("i", range(len(ORACLE)), ids=IDS)
def test_xw_matmul_matches_the_pallas_xwprequant_matmul(refs, i):
    b, k, n, bk, lw, ob_bits, ob = ORACLE[i]
    (x, w), (xq_want, wq_want, f32_want, q_want) = refs[0][i], refs[1][i]
    pol = _pol(bk, lw)
    xq, wq = prequant_act(t(x), pol), prequant_leaf(t(w), pol)
    for got, want in ((xq, xq_want), (wq, wq_want)):
        assert_bits_equal(got["m"], want["m"])
        assert_bits_equal(got["s"], want["s"])
    assert KM.matmul_core(True, bk, k, n, 8, lw, ob_bits, ob,
                          wire_x=True) == "mma"
    args = (xq["m"], xq["s"], wq["m"], wq["s"])
    assert_bits_equal(KM.bfp_matmul_xwprequant(*args, l_i=8, l_w=lw, bk=bk),
                      f32_want)
    m, s = KM.bfp_matmul_xwprequant(*args, l_i=8, l_w=lw, bk=bk,
                                    out_bits=ob_bits, out_block=ob)
    assert bool(torch.isfinite(s).all())
    assert_bits_equal(m, q_want["m"])
    assert_bits_equal(s, q_want["s"])


# -- the route as plain versions, with hazards ----------------------------

# (B, K, N, bk, L_W, out_bits, out_block)
ROUTE = [(5, 256, 64, 32, 8, 6, 4), (17, 512, 96, 128, 4, 3, 32),
         (3, 1024, 128, 512, 8, 8, 128), (8, 384, 200, 128, 6, 8, 8)]
RIDS = [f"B{c[0]}-K{c[1]}-N{c[2]}-bk{c[3]}-out{c[5]}x{c[6]}" for c in ROUTE]


def _wire_inputs(case, hazards):
    """Wire x (the activation format pass's rules, L 8) and a prequant
    weight (L_W).  With ``hazards``: an all-zero x block, x steps that are
    inf, NaN and subnormal, and an inf weight step."""
    b, k, n, bk, lw, *_ = case
    x = t(normal((b, k), seed=k + n, scale=2.0))
    if hazards:
        x[0, :bk] = 0.0
    xm, xs = KC.bfp_conv2d_xformat_plain(x.reshape(1, b, 1, k), 8, bk)
    xm, xs = xm.reshape(b, k), xs.reshape(b, k // bk)
    wq = prequant_leaf(t(normal((k, n), seed=n + bk, scale=0.05)),
                       _pol(bk, lw))
    wm, ws = wq["m"], wq["s"].clone()
    if hazards:
        xs[0, -1] = float("inf")
        xs[-1, 0] = float("nan")
        xs[1, 0] = 1e-40
        ws[-1, 1] = float("inf")
    return xm, xs, wm, ws


@pytest.mark.parametrize("epilogue", [False, True], ids=["f32", "epi"])
@pytest.mark.parametrize("i", range(len(ROUTE)), ids=RIDS)
def test_the_1x1_xw_conv_route_equals_the_xw_matmul(i, epilogue):
    """The core's route as plain versions — the 1x1 xw conv over
    ``[1, B, 1, K]`` and, with the epilogue, the output pass over
    ``[1, B, 1, N]`` — reshaped, against the matmul's plain version."""
    b, k, n, bk, lw, ob_bits, ob = ROUTE[i]
    xm, xs, wm, ws = _wire_inputs(ROUTE[i], hazards=True)
    epi = (ob_bits, ob) if epilogue else (None, None)
    want = KM.bfp_matmul_xwprequant_plain(xm, xs, wm, ws, 8, lw, bk, *epi)
    f32 = KC.bfp_conv2d_xwprequant_plain(
        xm.reshape(1, b, 1, k), xs.reshape(1, b, 1, k // bk),
        wm.reshape(1, 1, k, n), ws, 8, lw, bk, 1, "VALID")
    if epilogue:
        m, s = KC.bfp_conv2d_xformat_plain(f32, ob_bits, ob)
        got = (m.reshape(b, n), s.reshape(b, n // ob))
    else:
        got, want = (f32.reshape(b, n),), (want,)
    for g, w in zip(got, want):
        assert_bits_equal(g, w.numpy())
    # the hazards reach the output (an inf or NaN step)
    assert not bool(torch.isfinite(
        KM.bfp_matmul_xwprequant_plain(xm, xs, wm, ws, 8, lw, bk)).all())


def test_cpu_xwprequant_takes_the_plain_version(monkeypatch):
    """On the CPU the wrapper builds nothing and counts no launch, at a
    shape and policy whose card route is the mma core."""
    def no_build(name):
        raise AssertionError("a CPU call must not build or load a kernel")
    monkeypatch.setattr(_build, "load", no_build)
    case = ROUTE[1]
    b, k, n, bk, lw, ob_bits, ob = case
    assert KM.matmul_core(True, bk, k, n, 8, lw, ob_bits, ob,
                          wire_x=True) == "mma"
    xm, xs, wm, ws = _wire_inputs(case, hazards=False)
    K.reset_launch_counts()
    got = KM.bfp_matmul_xwprequant(xm, xs, wm, ws, l_i=8, l_w=lw, bk=bk,
                                   out_bits=ob_bits, out_block=ob)
    want = KM.bfp_matmul_xwprequant_plain(xm, xs, wm, ws, 8, lw, bk,
                                          ob_bits, ob)
    for g, w in zip(got, want):
        assert_bits_equal(g, w.numpy())
    assert not any(K.launch_counts().values())
