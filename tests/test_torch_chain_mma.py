"""The wire-x conv and the requantize epilogue as the int8 mma core's
routes compute them.

On the card a conv or matmul with ``out_bits`` runs its f32 route (the
activation format pass and the core, the patch format pass and the
core, or the core alone on a wire x) into a scratch tensor, and then the
activation format pass over that output per (row, ``out_block``
chunk); the x-prequant conv with float weights first formats the weight
once with the patch format pass's weight blocks
(``bfp_conv2d_wformat``) and runs the core on the wire x.  Here those
compositions of plain versions are held bit-equal to the fused plain
versions for every conv mode and both matmuls with f32 x, at out_bits
3/6/8, out_block 4-128 and blocks 32/128/512, with zero, NaN, inf and
subnormal inputs, wire steps and an inf weight; the output pass is held
to ``repro``'s epilogue block rule on the NaN / inf / zero / tie
blocks.  On normal-range data the same chains are held against
``repro``: the matmuls against its Pallas kernels in interpret mode, the
convs against its emulated TILED engine (the Pallas conv does not run on
this JAX version).  The route rule is pinned case by case.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as JEG
from repro.core import prequant as jpq
from repro.core.policy import TPU_TILED as J_TPU_TILED
from repro.kernels import bfp_matmul as jbm
from repro.kernels import ops
from repro_torch import kernels as K
from repro_torch.core.conv_utils import conv_geometry
from repro_torch.core.policy import TPU_TILED
from repro_torch.core.prequant import (prequant_act, prequant_conv_leaf,
                                       prequant_leaf)
from repro_torch.kernels import _build
from repro_torch.kernels import bfp_conv as KC
from repro_torch.kernels import bfp_matmul as KM
from test_torch_util import assert_bits_equal, normal, t, to_numpy_tree

MODES = ["xprequant", "xwprequant", "prequant", "inline"]
# (B, H, W, C, kernel, stride, padding, OC, bk, L, out_bits, out_block):
# ragged M, OC not a multiple of 128, blocks 32 / 128 / 512, out_block
# 4 .. 128, bk | C (the wire x needs it)
CONV_CASES = [(2, 9, 7, 64, 3, 1, "SAME", 40, 32, 8, 6, 4),
              (3, 7, 5, 128, 3, 2, "VALID", 96, 128, 4, 3, 32),
              (1, 5, 6, 512, 1, 1, "SAME", 128, 512, 8, 8, 128),
              (2, 6, 6, 256, 3, 1, "SAME", 64, 128, 8, 8, 16)]
CONV_IDS = [f"bk{c[8]}-L{c[9]}-out{c[10]}x{c[11]}" for c in CONV_CASES]
# (B, K, N, bk, L, out_bits, out_block); prequant weights where bk | K
MM_CASES = [(5, 256, 64, 32, 8, 6, 8), (8, 512, 256, 128, 4, 8, 128),
            (3, 1024, 96, 512, 8, 3, 32), (17, 300, 48, 32, 8, 8, 16)]
MM_IDS = [f"B{c[0]}-K{c[1]}-bk{c[3]}-out{c[5]}x{c[6]}" for c in MM_CASES]


def _equal(got, want):
    """Port outputs (tensors or (m, s) pairs) bit for bit, NaN-aware."""
    if not isinstance(want, tuple):
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_bits_equal(g, w.numpy())


def _conv_inputs(case, hazards):
    """f32 x, float w and the wire x of a case.  With ``hazards``: an
    all-zero pixel chunk, a NaN, an inf, a subnormal image, an inf
    weight, and wire steps that are inf, NaN and subnormal."""
    b, h, wd, c, kk, _, _, oc, bk, L, _, _ = case
    x = t(normal((b, h, wd, c), seed=c + oc, scale=2.0))
    w = t(normal((kk, kk, c, oc), seed=oc + kk, scale=0.05))
    if hazards:
        x[0, 0, 0, :bk] = 0.0
        x[0, 1, 1, 3] = float("nan")
        x[-1, 2, 2, bk - 1] = float("inf")
        if b > 1:
            x[1] = 1e-40 * torch.sign(x[1])
        w[0, 0, 1, 2] = float("inf")
    xm, xs = KC.bfp_conv2d_xformat_plain(x, L, bk)
    if hazards:
        xs[0, 2, 3, 0] = float("inf")
        xs[-1, 1, 1, -1] = float("nan")
        xs[0, 3, 2, 0] = 1e-40
    return x, w, xm, xs


def _conv_route(mode, case, x, w, xm, xs, wq, epilogue=True):
    """The mma core's route of ``mode`` as plain versions: the format
    pass(es), the wire conv (``bfp_conv2d_xwprequant_plain``: the core)
    and, with the epilogue, the output format pass over the f32 output
    (the activation format pass, per (pixel, out_block channel chunk))."""
    b, h, wd, c, kk, s, pad, oc, bk, L, ob_bits, ob = case
    if mode == "xprequant":
        wm, ws = KC.bfp_conv2d_wformat_plain(w, L, bk)
        f32 = KC.bfp_conv2d_xwprequant_plain(xm, xs, wm.reshape(w.shape),
                                             ws, 8, 8, bk, s, pad)
    elif mode == "xwprequant":
        f32 = KC.bfp_conv2d_xwprequant_plain(xm, xs, wq["m"], wq["s"], 8, 8,
                                             bk, s, pad)
    elif mode == "prequant":
        fm, fs = KC.bfp_conv2d_xformat_plain(x, L, bk)
        f32 = KC.bfp_conv2d_xwprequant_plain(fm, fs, wq["m"], wq["s"], 8, 8,
                                             bk, s, pad)
    else:   # inline: the patch pass, then the 1x1 conv over [1, M, 1, Kp]
        pm, ps, wm, ws = KC.bfp_conv2d_pformat_plain(x, w, L, L, bk, s, pad)
        m, kp = pm.shape
        oh, ow, _, _ = conv_geometry(h, wd, kk, kk, s, pad)
        f32 = KC.bfp_conv2d_xwprequant_plain(
            pm.reshape(1, m, 1, kp), ps.reshape(1, m, 1, kp // bk),
            wm.reshape(1, 1, kp, oc), ws, 8, 8, bk, 1,
            "VALID").reshape(b, oh, ow, oc)
    return (KC.bfp_conv2d_xformat_plain(f32, ob_bits, ob) if epilogue
            else f32)


def _conv_fused(mode, case, x, w, xm, xs, wq, epilogue=True):
    """The fused plain version of ``mode`` (the tile kernel's contract)."""
    _, _, _, _, _, s, pad, _, bk, L, ob_bits, ob = case
    epi = (ob_bits, ob) if epilogue else (None, None)
    if mode == "xprequant":
        return KC.bfp_conv2d_xprequant_plain(xm, xs, w, L, L, bk, s, pad,
                                             *epi)
    if mode == "xwprequant":
        return KC.bfp_conv2d_xwprequant_plain(xm, xs, wq["m"], wq["s"], L, 8,
                                              bk, s, pad, *epi)
    if mode == "prequant":
        return KC.bfp_conv2d_prequant_plain(x, wq["m"], wq["s"], L, 8, bk, s,
                                            pad, *epi)
    return KC.bfp_conv2d_plain(x, w, L, L, bk, s, pad, *epi)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("i", range(len(CONV_CASES)), ids=CONV_IDS)
def test_conv_route_then_output_pass_equals_the_fused_epilogue(i, mode):
    case = CONV_CASES[i]
    x, w, xm, xs = _conv_inputs(case, hazards=True)
    wq = prequant_conv_leaf(w, TPU_TILED.with_(block_k=case[8]))
    wq["s"][-1, 1] = float("inf")                  # an inf weight step
    want = _conv_fused(mode, case, x, w, xm, xs, wq)
    got = _conv_route(mode, case, x, w, xm, xs, wq)
    assert got[0].dtype == torch.int8 and got[1].shape[-1] * case[11] == \
        case[7]
    _equal(got, want)
    # the hazards reach the output: a zeroed (NaN) or saturated block
    f32 = _conv_fused(mode, case, x, w, xm, xs, wq, epilogue=False)
    assert not bool(torch.isfinite(f32).all())


@pytest.mark.parametrize("i", range(len(CONV_CASES)), ids=CONV_IDS)
def test_weight_pass_then_core_equals_the_xprequant_conv(i):
    """The x-prequant conv with an f32 output: the weight format pass
    (once per call, the patch pass's weight blocks: Kp = K since bk | C)
    and the wire conv equal the x-prequant conv's plain version."""
    case = CONV_CASES[i]
    x, w, xm, xs = _conv_inputs(case, hazards=True)
    kh, kw, c, oc = w.shape
    wm, ws = KC.bfp_conv2d_wformat_plain(w, case[9], case[8])
    assert wm.shape == (kh * kw * c, oc) and wm.dtype == torch.int8
    assert ws.shape == (kh * kw * c // case[8], oc)
    # the patch format pass's weight half, block for block
    pw = KC.bfp_conv2d_pformat_plain(x, w, case[9], case[9], case[8],
                                     case[5], case[6])[2:]
    _equal((wm, ws), pw)
    _equal(_conv_route("xprequant", case, x, w, xm, xs, None, False),
           _conv_fused("xprequant", case, x, w, xm, xs, None, False))


def _mm_inputs(case, hazards):
    b, k, n, bk, *_ = case
    x = t(normal((b, k), seed=k + n, scale=2.0))
    w = t(normal((k, n), seed=n, scale=0.05))
    if hazards:
        x[0, :bk] = 0.0
        x[1, 3] = float("nan")
        x[2, k - 1] = float("inf")
        x[-1] = 1e-40 * torch.sign(x[-1])
        w[k // 3, 1] = float("inf")
    return x, w


def _mm_route(prequant, case, x, w, wq):
    """A matmul with f32 x on the core as the 1x1 conv over [1, B, 1, K]:
    the activation (prequant) or patch (inline) format pass, the core,
    then the output pass over [1, B, 1, N]."""
    b, k, n, bk, L, ob_bits, ob = case
    if prequant:
        xm, xs = KC.bfp_conv2d_xformat_plain(x.reshape(1, b, 1, k), L, bk)
        f32 = KC.bfp_conv2d_xwprequant_plain(
            xm, xs, wq["m"].reshape(1, 1, k, n), wq["s"], L, 8, bk, 1,
            "VALID")
    else:
        xm, xs, wm, ws = KC.bfp_conv2d_pformat_plain(
            x.reshape(1, b, 1, k), w.reshape(1, 1, k, n), L, L, bk, 1,
            "VALID")
        kp = xm.shape[1]
        f32 = KC.bfp_conv2d_xwprequant_plain(
            xm.reshape(1, b, 1, kp), xs.reshape(1, b, 1, kp // bk),
            wm.reshape(1, 1, kp, n), ws, L, L, bk, 1, "VALID")
    m, s = KC.bfp_conv2d_xformat_plain(f32, ob_bits, ob)
    return m.reshape(b, n), s.reshape(b, n // ob)


# (case, prequant weights): prequant where bk | K
MM_ROUTES_RUN = [(i, p) for i, c in enumerate(MM_CASES) for p in (True, False)
                 if not (p and c[1] % c[3])]


@pytest.mark.parametrize("i,prequant", MM_ROUTES_RUN,
                         ids=[MM_IDS[i] + ("-prequant" if p else "-inline")
                              for i, p in MM_ROUTES_RUN])
def test_matmul_route_then_output_pass_equals_the_fused_epilogue(i,
                                                                 prequant):
    case = MM_CASES[i]
    b, k, n, bk, L, ob_bits, ob = case
    x, w = _mm_inputs(case, hazards=True)
    if prequant:
        wq = prequant_leaf(w, TPU_TILED.with_(block_k=bk))
        wq["s"][-1, 1] = float("inf")
        want = KM.bfp_matmul_prequant_plain(x, wq["m"], wq["s"], L, 8, bk,
                                            ob_bits, ob)
    else:
        wq = None
        want = KM.bfp_matmul_plain(x, w, L, L, bk, ob_bits, ob)
    _equal(_mm_route(prequant, case, x, w, wq), want)


@pytest.mark.parametrize("bits,block", [(8, 4), (8, 8), (6, 16), (3, 32)])
def test_output_pass_takes_the_epilogue_block_rule(bits, block):
    """The output pass is the activation format pass over the f32 output
    in ``out_block`` chunks: on a NaN block, an all-zero block, an inf
    block and ties it gives ``repro``'s ``_block_format`` per chunk
    (the rule of its fused epilogue, ``_requant_store``)."""
    acc = normal((4, 32), seed=31, scale=3.0)
    acc[0, 3] = np.nan
    acc[1, 8:16] = 0.0
    acc[2, 17] = np.inf
    acc[3, 24:] = np.float32(2.0 ** -6) * np.array(
        [2.5, -3.5, 0.5, 64.0, 1.5, -0.5, 7.5, 127.0], np.float32)

    def ref(a):
        ms, ss = [], []
        for c in range(a.shape[1] // block):
            m, s = jbm._block_format(a[:, c * block:(c + 1) * block], bits,
                                     axis=1, mdtype=jnp.int8)
            ms.append(m)
            ss.append(s)
        return jnp.concatenate(ms, 1), jnp.concatenate(ss, 1)
    want_m, want_s = to_numpy_tree(jax.jit(ref)(acc))
    m, s = KC.bfp_conv2d_xformat_plain(t(acc).reshape(1, 4, 1, 32), bits,
                                       block)
    assert_bits_equal(m.reshape(4, 32), want_m)
    assert_bits_equal(s.reshape(4, 32 // block), want_s)
    _equal((m.reshape(4, 32), s.reshape(4, 32 // block)),
           KM.requant_plain(t(acc), bits, block))


# -- against repro, on normal-range data (XLA:CPU flushes subnormals) -----

# (B, H, W, C, kernel, stride, padding, OC, bk, L, out_bits, out_block)
ORACLE_CONV = [(2, 6, 5, 32, 3, 1, "SAME", 24, 16, 8, 8, 8),
               (1, 7, 7, 32, 3, 2, "VALID", 16, 32, 4, 6, 16)]
# (B, K, N, bk, L, out_bits, out_block)
ORACLE_MM = [(3, 96, 48, 32, 8, 8, 16), (4, 256, 64, 128, 4, 6, 32)]


def _jpol(bk, L):
    return J_TPU_TILED.with_(block_k=bk, l_i=L, l_w=L, straight_through=False)


@pytest.fixture(scope="module")
def refs():
    """``repro``'s outputs for the oracle cases, in one compiled program:
    its activation and weight wire formats, its emulated TILED convs on
    them (wire x and float / prequant w, f32 x and float / prequant w)
    and its Pallas matmuls (inline and prequant), each with the case's
    out_policy."""
    def ref_fn(conv_inputs, mm_inputs):
        cv = []
        for (x, w), case in zip(conv_inputs, ORACLE_CONV):
            _, _, _, _, _, s, pad, _, bk, L, ob_bits, ob = case
            pol = _jpol(bk, L).with_(backend="emulated")
            opol = J_TPU_TILED.with_(block_k=ob, l_i=ob_bits)
            xq, wq = jpq.prequant_act(x, pol), jpq.prequant_conv_leaf(w, pol)
            cv.append((xq, wq) + tuple(
                JEG.conv2d(a, b, pol, stride=s, padding=pad,
                           out_policy=opol)
                for a, b in ((xq, w), (xq, wq), (x, wq), (x, w))))
        mm = []
        for (x, w), case in zip(mm_inputs, ORACLE_MM):
            _, _, _, bk, L, ob_bits, ob = case
            pol = _jpol(bk, L)
            opol = J_TPU_TILED.with_(block_k=ob, l_i=ob_bits)
            wq = jpq.prequant_leaf(w, pol.with_(l_w=8))
            mm.append((wq, ops.bfp_matmul(x, w, pol, interpret=True,
                                          out_policy=opol),
                       ops.bfp_matmul_prequant(x, wq["m"], wq["s"],
                                               pol.with_(l_w=8),
                                               interpret=True,
                                               out_policy=opol)))
        return cv, mm
    conv_in = [tuple(a.numpy() for a in _conv_inputs(c, False)[:2])
               for c in ORACLE_CONV]
    mm_in = [tuple(a.numpy() for a in _mm_inputs(c, False))
             for c in ORACLE_MM]
    return to_numpy_tree(jax.jit(ref_fn)(conv_in, mm_in))


def _assert_wire(got, want):
    assert_bits_equal(got[0], want["m"])
    assert_bits_equal(got[1], want["s"])


@pytest.mark.parametrize("i", range(len(ORACLE_CONV)))
def test_conv_routes_match_the_emulated_engine(refs, i):
    case = ORACLE_CONV[i]
    bk, L = case[8], case[9]
    x, w, _, _ = _conv_inputs(case, False)
    xq_want, wq_want, *want = refs[0][i]
    pol = TPU_TILED.with_(block_k=bk, l_i=L, l_w=L, straight_through=False)
    xq = prequant_act(x, pol)
    wq = prequant_conv_leaf(w, pol)
    for mine, ref_ in ((xq, xq_want), (wq, wq_want)):
        assert_bits_equal(mine["m"], ref_["m"])
        assert_bits_equal(mine["s"], ref_["s"])
    for mode, ref_out in zip(("xprequant", "xwprequant", "prequant",
                              "inline"), want):
        got = _conv_route(mode, case, x, w, xq["m"], xq["s"], wq)
        assert bool(torch.isfinite(got[1]).all())
        _assert_wire(got, ref_out)


@pytest.mark.parametrize("i", range(len(ORACLE_MM)))
def test_matmul_routes_match_the_pallas_matmuls(refs, i):
    case = ORACLE_MM[i]
    x, w = _mm_inputs(case, False)
    wq_want, inline, prequant = refs[1][i]
    wq = prequant_leaf(w, TPU_TILED.with_(block_k=case[3], l_w=8))
    assert_bits_equal(wq["m"], wq_want["m"])
    assert_bits_equal(wq["s"], wq_want["s"])
    _assert_wire(_mm_route(False, case, x, w, None), inline)
    _assert_wire(_mm_route(True, case, x, w, wq), prequant)


# -- the route rule ---------------------------------------------------------

# conv_core(wire_x, prequant_w, bk, C, OC, L_I, out_bits, L_W, out_block)
CONV_ROUTES = [
    ("xprequant f32", (True, False, 128, 256, 256, 8, None, 8, None), "mma"),
    ("xprequant epi", (True, False, 128, 256, 256, 8, 8, 8, 128), "mma"),
    ("xprequant L_I 12", (True, False, 128, 256, 256, 12, 8, 8, 4), "mma"),
    ("xwprequant epi", (True, True, 512, 512, 40, 8, 6, 8, 4), "mma"),
    ("prequant epi", (False, True, 32, 64, 96, 8, 3, 8, 32), "mma"),
    ("inline epi", (False, False, 128, 3, 64, 8, 8, 8, 64), "mma"),
    ("xprequant L_W 9", (True, False, 128, 256, 256, 8, None, 9, None),
     "tile"),
    ("xprequant bk !| C", (True, False, 128, 64, 256, 8, None, 8, None),
     "tile"),
    ("xprequant bk 96", (True, False, 96, 192, 256, 8, None, 8, None),
     "tile"),
    ("xprequant bk 1024", (True, False, 1024, 1024, 256, 8, None, 8, None),
     "tile"),
    ("xprequant OC 30", (True, False, 128, 256, 30, 8, None, 8, None),
     "tile"),
    ("out_block 2", (True, True, 128, 256, 256, 8, 8, 8, 2), "tile"),
    ("out_block !| OC", (False, True, 128, 256, 40, 8, 8, 8, 16), "tile"),
    ("out_bits 9", (False, False, 128, 256, 256, 8, 9, 8, 32), "tile"),
    ("out_block None", (True, True, 128, 256, 256, 8, 8, 8, None), "tile"),
    ("inline L_I 9 epi", (False, False, 128, 64, 64, 9, 8, 8, 32), "tile"),
]
# matmul_core(prequant_w, bk, K, N, L_I, L_W, out_bits, out_block[,
# wire_x]): the wire-x matmuls (chain B's fc7-8 with float weights, chain
# A's with prequant weights) take the mma core where the x-prequant and
# xw-prequant convs do
MM_ROUTES = [
    ("fc6 prequant epi", (True, 128, 25088, 4096, 8, 8, 8, 128), "mma"),
    ("fc6 inline epi", (False, 128, 25088, 4096, 8, 8, 8, 128), "mma"),
    ("ragged K inline", (False, 32, 2047, 44, 8, 8, 6, 4), "mma"),
    ("out_block 2", (True, 128, 2048, 1000, 8, 8, 8, 2), "tile"),
    ("out_block !| N", (True, 128, 2048, 1000, 8, 8, 8, 16), "tile"),
    ("L_I 12 epi", (True, 128, 2048, 1024, 12, 8, 8, 8), "tile"),
    ("fc7 wire x epi", (False, 128, 4096, 4096, 8, 8, 8, 128, True), "mma"),
    ("fc8 wire x", (False, 128, 4096, 1000, 8, 8, None, None, True), "mma"),
    ("wire x bk 32 ob 4", (False, 32, 512, 44, 8, 4, 6, 4, True), "mma"),
    ("wire x bk 512", (False, 512, 1024, 128, 8, 8, 3, 32, True), "mma"),
    ("wire x L_I 12", (False, 128, 4096, 4096, 12, 8, None, None, True),
     "mma"),
    ("wire x L_W 9", (False, 128, 4096, 4096, 8, 9, 8, 128, True), "tile"),
    ("wire x N 1002", (False, 128, 4096, 1002, 8, 8, None, None, True),
     "tile"),
    ("wire x out_block 2", (False, 128, 4096, 1000, 8, 8, 8, 2, True),
     "tile"),
    ("wire x bk 96", (False, 96, 4032, 1000, 8, 8, None, None, True),
     "tile"),
    ("xw wire", (True, 128, 4096, 4096, 8, 8, 8, 128, True), "mma"),
    ("xw wire f32", (True, 128, 4096, 1000, 8, 8, None, None, True),
     "mma"),
    ("xw bk 96", (True, 96, 4032, 1000, 8, 8, None, None, True), "tile"),
    ("xw N 1002", (True, 128, 4096, 1002, 8, 8, None, None, True), "tile"),
    ("xw out_block 2", (True, 128, 4096, 1000, 8, 8, 8, 2, True), "tile"),
]


@pytest.mark.parametrize("args,core", [r[1:] for r in CONV_ROUTES],
                         ids=[r[0] for r in CONV_ROUTES])
def test_conv_route_rule(args, core):
    assert KC.conv_core(*args) == core


@pytest.mark.parametrize("args,core", [r[1:] for r in MM_ROUTES],
                         ids=[r[0] for r in MM_ROUTES])
def test_matmul_route_rule(args, core):
    assert KM.matmul_core(*args) == core


# (layer, wire x, C, OC) of the VGG16 chains' convs, each with the next
# layer's out_policy (block 128, L 8) or none (a stage's last conv)
CHAIN_CONVS = [("conv2_1", False, 64, 128), ("conv2_2", True, 128, 128),
               ("conv3_1", False, 128, 256), ("conv3_2", True, 256, 256),
               ("conv4_1", False, 256, 512), ("conv4_2", True, 512, 512),
               ("conv5_1", False, 512, 512), ("conv5_3", True, 512, 512)]


@pytest.mark.parametrize("layer,wire,c,oc", CHAIN_CONVS,
                         ids=[r[0] for r in CHAIN_CONVS])
@pytest.mark.parametrize("prequant", [True, False], ids=["A", "B"])
def test_every_chain_conv_takes_the_mma_core(layer, wire, c, oc, prequant):
    """Chain A (weights prequantized; conv2_1's K = 576 stays inline) and
    chain B (float weights), with and without the epilogue."""
    pq = prequant and layer != "conv2_1"
    for epi in ((8, 128), (None, None)):
        assert KC.conv_core(wire, pq, 128, c, oc, 8, epi[0], 8,
                            epi[1]) == "mma"


def test_cpu_wformat_and_epilogue_take_the_plain_version(monkeypatch):
    def no_build(name):
        raise AssertionError("a CPU call must not build or load a kernel")
    monkeypatch.setattr(_build, "load", no_build)
    K.reset_launch_counts()
    case = CONV_CASES[0]
    x, w, xm, xs = _conv_inputs(case, hazards=False)
    _equal(KC.bfp_conv2d_wformat(w, l_w=8, bk=32),
           KC.bfp_conv2d_wformat_plain(w, 8, 32))
    _equal(KC.bfp_conv2d_xprequant(xm, xs, w, l_i=8, l_w=8, bk=32,
                                   out_bits=6, out_block=4),
           KC.bfp_conv2d_xprequant_plain(xm, xs, w, 8, 8, 32, 1, "SAME", 6,
                                         4))
    counts = K.launch_counts()
    assert set(counts.values()) == {0}
    assert {"bfp_conv2d_wformat", "bfp_conv2d_oformat",
            "bfp_matmul_oformat"} <= set(counts)
    with pytest.raises(ValueError, match="weight format pass"):
        KC.bfp_conv2d_wformat(w, l_w=9, bk=32)
    with pytest.raises(ValueError, match="weight format pass"):
        KC.bfp_conv2d_wformat(w, l_w=8, bk=48)


def test_epilogue_counts_a_layer_once_however_its_rows_are_chunked():
    """A layer chunked into several host calls counts each call's core
    and passes, and the layer once under ``_epilogue``."""
    from collections import Counter
    from repro_torch.kernels import _mma
    counts = Counter()
    for row0 in (0, 100, 200):
        _mma._count(counts, "bfp_matmul", "bfp_matmul_prequant", 6,
                    "_xformat", layer=row0 == 0)
    _mma._count(counts, "bfp_conv2d", "bfp_conv2d", None, "_pformat")
    assert counts == {"bfp_matmul_prequant": 3, "bfp_matmul_xformat": 3,
                      "bfp_matmul_oformat": 3, "bfp_matmul_epilogue": 1,
                      "bfp_conv2d": 1, "bfp_conv2d_pformat": 1}
