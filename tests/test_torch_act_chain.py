"""Port parity for chained BFP layers on the activation wire format
(counterpart of ``test_act_chain.py``).

``out_policy=`` makes a layer emit the next layer's quantized input
(int8 mantissas + power-of-two steps, ``{"m", "s"}``) from its
accumulator, and a wire-format ``x`` feeds the x-prequant kernels as it
is.  The plain versions of those kernels, with and without the
requantize epilogue, are held bit for bit against ``repro``: the matmul
against its Pallas kernels in interpret mode, the conv against its
emulated TILED engine (the Pallas conv does not run on this JAX
version).  Data stays in the normal float range, since XLA:CPU flushes
subnormal operands.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as JEG
from repro.core import prequant as jpq
from repro.core.policy import TPU_TILED as J_TPU_TILED
from repro.engine import PolicyMap as JPolicyMap
from repro.kernels import bfp_matmul as jbm
from repro.kernels import ops
from repro_torch import engine as EG
from repro_torch import kernels as K
from repro_torch.convert import params_from_numpy
from repro_torch.core.bfp import Rounding
from repro_torch.core.policy import BFPPolicy, TPU_TILED
from repro_torch.core.prequant import (dequantize_act, is_prequant,
                                       prequant_act)
from repro_torch.engine import PolicyMap
from repro_torch.kernels import _build
from repro_torch.kernels import bfp_conv as KC
from repro_torch.kernels import bfp_matmul as KM
from repro_torch.kernels import ops as pops
from test_torch_util import assert_bits_equal, normal, t, to_numpy_tree

PALLAS16 = TPU_TILED.with_(block_k=16, backend="pallas",
                           straight_through=False)

# (B, K, N, bk, L, out_block): ragged N (not a multiple of any column
# tile), out_block 8 / 16 / none, L 8 and 4; columns 0..7 of w are zero,
# so with out_block 8 the first output block is all zero
MMX_CASES = [(5, 64, 40, 16, 8, 8), (4, 96, 48, 32, 8, 16),
             (3, 64, 24, 8, 4, None)]
# (stride, kernel, padding, bk, L, C, OC, out_block); image 1 is all zero
CONVX_CASES = [(1, 3, "SAME", 8, 8, 16, 24, 8),
               (2, 3, "SAME", 16, 8, 32, 32, 16),
               (2, 3, "VALID", 8, 4, 8, 40, None),
               (1, 1, "VALID", 8, 8, 8, 16, 16)]


def _mm_data(case):
    b, k, n, *_ = case
    x = normal((b, k), seed=k + n, scale=2.0)
    x[0] = 0.0
    w = normal((k, n), seed=n, scale=0.1)
    w[:, :8] = 0.0
    return x, w


def _conv_data(case):
    s, kk, _, _, _, c, oc, _ = case
    x = normal((2, 9, 10, c), seed=c + s, scale=2.0)
    x[1] = 0.0
    return x, normal((kk, kk, c, oc), seed=oc + kk, scale=0.1)


def _jpol(bk, L):
    return J_TPU_TILED.with_(block_k=bk, l_i=L, l_w=L,
                             straight_through=False)


def _pol(bk, L):
    return TPU_TILED.with_(block_k=bk, l_i=L, l_w=L, straight_through=False)


def _opol(jax_side, ob):
    if ob is None:
        return None
    return (J_TPU_TILED if jax_side else TPU_TILED).with_(
        block_k=ob, straight_through=False)


@pytest.fixture(scope="module")
def refs():
    """Every reference of this module's kernel cases in one compiled
    program: the activation and weight wire formats, the Pallas matmuls
    on a wire x (float and prequant w, each with its case's out_policy),
    and the emulated TILED convs likewise."""
    def ref_fn(mm_inputs, conv_inputs):
        mm = []
        for (x, w), (b, k, n, bk, L, ob) in zip(mm_inputs, MMX_CASES):
            pol = _jpol(bk, L)
            xq = jpq.prequant_act(x, pol)
            wq = jpq.prequant_leaf(w, pol)
            opol = _opol(True, ob)
            mm.append((xq, wq,
                       ops.bfp_matmul(xq, w, pol, interpret=True,
                                      out_policy=opol),
                       ops.bfp_matmul_prequant(xq, wq["m"], wq["s"], pol,
                                               interpret=True,
                                               out_policy=opol)))
        cv = []
        for (x, w), (s, _, pad, bk, L, _, _, ob) in zip(conv_inputs,
                                                        CONVX_CASES):
            pol = _jpol(bk, L).with_(backend="emulated")
            xq = jpq.prequant_act(x, pol)
            wq = jpq.prequant_conv_leaf(w, pol)
            opol = _opol(True, ob)
            cv.append((xq, wq,
                       JEG.conv2d(xq, w, pol, stride=s, padding=pad,
                                  out_policy=opol),
                       JEG.conv2d(xq, wq, pol, stride=s, padding=pad,
                                  out_policy=opol)))
        return mm, cv
    return to_numpy_tree(jax.jit(ref_fn)(
        [_mm_data(c) for c in MMX_CASES],
        [_conv_data(c) for c in CONVX_CASES]))


def _assert_wire_equal(got, want) -> None:
    """A port output (dict, (m, s) pair or tensor) equals a reference
    output (dict or array) bit for bit."""
    if isinstance(got, tuple):
        got = {"m": got[0], "s": got[1]}
    if is_prequant(want):
        assert is_prequant(got)
        assert_bits_equal(got["m"], want["m"])
        assert_bits_equal(got["s"], want["s"])
    else:
        assert_bits_equal(got, want)


def _epi(ob, L=8):
    return {} if ob is None else {"out_bits": L, "out_block": ob}


@pytest.mark.parametrize("case", range(len(MMX_CASES)))
@pytest.mark.parametrize("weights", ["float", "prequant"])
def test_matmul_wire_x_plain_matches_pallas(refs, case, weights):
    """x-prequant and xw-prequant matmul plain versions, with the case's
    epilogue, and the policy wrapper on a dict x with ``out_policy``."""
    b, k, n, bk, L, ob = MMX_CASES[case]
    x, w = _mm_data(MMX_CASES[case])
    xq, wq, want_f, want_q = refs[0][case]
    mine = prequant_act(t(x), _pol(bk, L))
    _assert_wire_equal(mine, xq)
    xm, xs = mine["m"], mine["s"]
    pol = _pol(bk, L)
    if weights == "float":
        got = KM.bfp_matmul_xprequant_plain(xm, xs, t(w), L, L, bk,
                                            **_epi(ob))
        via_ops = pops.bfp_matmul(mine, t(w), pol, out_policy=_opol(False, ob))
        want = want_f
    else:
        wm, ws = t(wq["m"]), t(wq["s"])
        got = KM.bfp_matmul_xwprequant_plain(xm, xs, wm, ws, L, L, bk,
                                             **_epi(ob))
        via_ops = pops.bfp_matmul_prequant(mine, wm, ws, pol,
                                           out_policy=_opol(False, ob))
        want = want_q
    _assert_wire_equal(got, want)
    _assert_wire_equal(via_ops, want)


@pytest.mark.parametrize("case", range(len(CONVX_CASES)))
@pytest.mark.parametrize("weights", ["float", "prequant"])
def test_conv_wire_x_plain_matches_emulated_engine(refs, case, weights):
    """x-prequant and xw-prequant conv plain versions (mantissa and step
    patches gathered by im2col, stride 1 and 2) against repro's emulated
    TILED engine on the same wire-format input."""
    s, kk, pad, bk, L, c, oc, ob = CONVX_CASES[case]
    x, w = _conv_data(CONVX_CASES[case])
    xq, wq, want_f, want_q = refs[1][case]
    mine = prequant_act(t(x), _pol(bk, L))
    _assert_wire_equal(mine, xq)
    xm, xs = mine["m"], mine["s"]
    pol = _pol(bk, L)
    if weights == "float":
        got = KC.bfp_conv2d_xprequant_plain(xm, xs, t(w), L, L, bk, s, pad,
                                            **_epi(ob))
        via_ops = pops.bfp_conv2d(mine, t(w), pol, s, pad,
                                  out_policy=_opol(False, ob))
        want = want_f
    else:
        wm, ws = t(wq["m"]), t(wq["s"])
        got = KC.bfp_conv2d_xwprequant_plain(xm, xs, wm, ws, L, L, bk, s,
                                             pad, **_epi(ob))
        via_ops = pops.bfp_conv2d_prequant(mine, wm, ws, pol, s, pad,
                                           out_policy=_opol(False, ob))
        want = want_q
    _assert_wire_equal(got, want)
    _assert_wire_equal(via_ops, want)


def test_epilogue_block_rules_match_requant_store():
    """The plain epilogue takes the kernels' block rules (repro's
    ``_requant_store``): a NaN block and an all-zero block become zeros
    with the zero-block step, an inf block saturates, ties round half to
    even."""
    acc = normal((4, 32), seed=31, scale=3.0)
    acc[0, 3] = np.nan
    acc[1, 8:16] = 0.0
    acc[2, 17] = np.inf
    acc[3, 24:] = np.float32(2.0 ** -6) * np.array(
        [2.5, -3.5, 0.5, 64.0, 1.5, -0.5, 7.5, 127.0], np.float32)
    for bits, block in ((8, 8), (6, 16), (3, 32)):
        def ref(a):
            ms, ss = [], []
            for c in range(a.shape[1] // block):
                m, s = jbm._block_format(a[:, c * block:(c + 1) * block],
                                         bits, axis=1, mdtype=jnp.int8)
                ms.append(m)
                ss.append(s)
            return jnp.concatenate(ms, 1), jnp.concatenate(ss, 1)
        want_m, want_s = to_numpy_tree(jax.jit(ref)(acc))
        m, s = KM.requant_plain(t(acc), bits, block)
        assert_bits_equal(m, want_m)
        assert_bits_equal(s, want_s)
    assert (m[0].numpy() == 0).all()


@pytest.mark.parametrize("prequant", [False, True])
@pytest.mark.parametrize("op", ["gemm", "conv"])
def test_out_policy_equals_two_step_and_chain_equals_float_chain(op,
                                                                 prequant):
    """On the CPU backend: ``out_policy=`` output == the layer, then
    ``prequant_act``; the chain on the wire format == the chain on float
    activations (the consumer's inline quantization lands on the same
    grid)."""
    pol = PALLAS16
    if op == "gemm":
        x = t(normal((6, 48), seed=41, scale=2.0))
        w1 = t(normal((48, 32), seed=42, scale=0.1))
        w2 = t(normal((32, 24), seed=43, scale=0.1))
        if prequant:
            w1, w2 = (EG.prequantize_cnn({"fc": {"w": a}}, pol)["fc"]["w"]
                      for a in (w1, w2))

        def run(a, w, **kw):
            return EG.gemm(a, w, pol, **kw)
    else:
        x = t(normal((2, 7, 6, 16), seed=44, scale=2.0))
        w1 = t(normal((3, 3, 16, 32), seed=45, scale=0.1))
        w2 = t(normal((3, 3, 32, 24), seed=46, scale=0.1))
        if prequant:
            w1, w2 = (EG.prequantize_cnn({"c": {"w": a}}, pol)["c"]["w"]
                      for a in (w1, w2))

        def run(a, w, **kw):
            return EG.conv2d(a, w, pol, **kw)
    y = run(x, w1, out_policy=pol)
    assert is_prequant(y) and y["m"].dtype == torch.int8
    _assert_wire_equal(y, {k: v.numpy() for k, v in
                           prequant_act(run(x, w1), pol).items()})
    assert_bits_equal(run(y, w2), run(run(x, w1), w2).numpy())
    assert_bits_equal(run(y, w2), run(dequantize_act(y), w2).numpy())


def test_epilogue_fuses_only_where_the_blocks_fit(monkeypatch):
    """The fused-or-two-step rule of repro's ops: out_policy.l_i <= 8,
    block_k | N and block_k | the kernel's column tile.  Either way the
    result is the same dict."""
    seen = []
    real = KM.bfp_matmul

    def spy(*a, **kw):
        seen.append(kw.get("out_bits"))
        return real(*a, **kw)
    monkeypatch.setattr(KM, "bfp_matmul", spy)
    x = t(normal((3, 64), seed=51, scale=2.0))
    w = t(normal((64, 512), seed=52, scale=0.1))
    # (out_policy block, out_bits the kernel got): 256 is wider than the
    # kernel's column tile, so it takes the two-step route
    for block, fused in ((128, 8), (64, 8), (256, None)):
        seen.clear()
        opol = TPU_TILED.with_(block_k=block)
        got = pops.bfp_matmul(x, w, PALLAS16, out_policy=opol)
        assert seen == [fused]
        _assert_wire_equal(got, {k: v.numpy() for k, v in prequant_act(
            KM.bfp_matmul_plain(x, w, 8, 8, 16), opol).items()})
    with pytest.raises(ValueError, match="block_k"):      # 96 does not
        pops.bfp_matmul(x, w, PALLAS16,                    # divide N
                        out_policy=TPU_TILED.with_(block_k=96))
    assert pops._epilogue_cfg(TPU_TILED.with_(block_k=16, l_i=10), 64) is None


def test_out_policy_rejects_non_wire_format():
    x, w = t(normal((4, 32), seed=61)), t(normal((32, 16), seed=62))
    with pytest.raises(ValueError, match="TILED"):
        EG.gemm(x, w, PALLAS16, out_policy=BFPPolicy(straight_through=False))
    with pytest.raises(ValueError, match="round-to-nearest"):
        EG.gemm(x, w, PALLAS16,
                out_policy=PALLAS16.with_(rounding=Rounding.STOCHASTIC))
    # a wire x blocked at 12 (= C) against weights blocked at 36: the
    # weight block does not divide C, so no K-tile is one act block
    xc = prequant_act(t(normal((1, 5, 5, 12), seed=63)),
                      PALLAS16.with_(block_k=12))
    wq = EG.prequantize_cnn({"c": {"w": t(normal((3, 3, 12, 8), seed=64))}},
                            PALLAS16.with_(block_k=36))["c"]["w"]
    with pytest.raises(ValueError, match=r"block_k \| C"):
        pops.bfp_conv2d_prequant(xc, wq["m"], wq["s"],
                                 PALLAS16.with_(block_k=None))
    with pytest.raises(ValueError, match="activation prequant block"):
        pops.bfp_matmul(prequant_act(x, PALLAS16.with_(block_k=8)), w,
                        PALLAS16)


def _toy_params(seed=70):
    return {"fc1": {"w": t(normal((32, 32), seed=seed, scale=0.1))},
            "fc2": {"w": t(normal((32, 16), seed=seed + 1, scale=0.1))}}


def test_plan_out_policy_for():
    plan = EG.bind(_toy_params(), PALLAS16, device="cpu")
    assert plan.out_policy_for("fc2") == PALLAS16
    assert EG.bind(_toy_params(), None, device="cpu").out_policy_for(
        "fc2") is None
    plan_w = EG.bind(_toy_params(), PALLAS16.with_(l_i=10), device="cpu")
    assert plan_w.out_policy_for("fc2") is None     # not int8 on the wire
    # a stochastic consumer: its inputs are not the wire format (fc2 is
    # left unbound, since the port has no backend that runs it)
    stoch = PolicyMap.of(("^fc2$", PALLAS16.with_(
        rounding=Rounding.STOCHASTIC)), default=PALLAS16)
    plan_s = EG.bind({"fc1": _toy_params()["fc1"]}, stoch,
                     prequantize=False, device="cpu")
    assert plan_s.out_policy_for("fc2") is None
    assert plan_s.out_policy_for("fc1") == PALLAS16


def test_leading_dims_restored_on_wire_format():
    x = t(normal((2, 3, 32), seed=71, scale=2.0))
    w = _toy_params()["fc2"]["w"]
    y = EG.gemm(x, w, PALLAS16, out_policy=PALLAS16)
    assert y["m"].shape == (2, 3, 16) and y["s"].shape == (2, 3, 1)
    flat = EG.gemm(x.reshape(6, 32), w, PALLAS16, out_policy=PALLAS16)
    assert torch.equal(y["m"], flat["m"].reshape(2, 3, 16))
    out = EG.gemm(y, _toy_params()["fc1"]["w"][:16], PALLAS16)
    assert out.shape == (2, 3, 32)


def test_conv2d_im2col_accepts_wire_format():
    """The fallback route dequantizes a dict x and honours out_policy;
    held against repro's same route on the emulated engine."""
    x = normal((2, 6, 6, 8), seed=72, scale=2.0)
    w = normal((3, 3, 8, 16), seed=73, scale=0.1)
    jpol = J_TPU_TILED.with_(block_k=24, straight_through=False,
                             backend="emulated")
    want = to_numpy_tree(jax.jit(lambda a, b: JEG.conv2d_im2col(
        jpq.prequant_act(a, J_TPU_TILED.with_(block_k=8)), b, jpol,
        out_policy=J_TPU_TILED.with_(block_k=16)))(x, w))
    xq = prequant_act(t(x), TPU_TILED.with_(block_k=8))
    y = EG.conv2d_im2col(xq, t(w), PALLAS16.with_(block_k=24),
                         out_policy=TPU_TILED.with_(block_k=16))
    assert y["m"].shape == (2, 6, 6, 16)
    _assert_wire_equal(y, want)


# -- the slice as a whole: bound plans chaining two convs and two FCs -------

_CHAIN = [("c1", "conv"), ("c2", "conv"), ("fc1", "gemm"), ("fc2", "gemm")]


def _chain_params():
    return {"c1": {"w": normal((3, 3, 16, 32), seed=81, scale=0.1)},
            "c2": {"w": normal((3, 3, 32, 32), seed=82, scale=0.1)},
            "fc1": {"w": normal((4 * 4 * 32, 32), seed=83, scale=0.05)},
            "fc2": {"w": normal((32, 24), seed=84, scale=0.1)}}


def _run_chain(plan, params, x, ops_):
    """c1 -> c2 (stride 2) -> flatten -> fc1 -> fc2, every producer
    handing its consumer the wire format; returns every layer output."""
    outs = []
    y = x
    for i, (name, kind) in enumerate(_CHAIN):
        nxt = _CHAIN[i + 1][0] if i + 1 < len(_CHAIN) else None
        opol = plan.out_policy_for(nxt) if nxt else None
        w = params[name]["w"]
        if kind == "conv":
            y = plan.conv2d(y, w, path=name, stride=1 if name == "c1" else 2,
                            out_policy=opol)
        else:
            if name == "fc1":       # NHWC flatten keeps the C-chunk blocks
                y = {k: ops_.reshape(v, (v.shape[0], -1))
                     for k, v in y.items()}
            y = plan.gemm(y, w, path=name, out_policy=opol)
        outs.append(y)
    return outs


@pytest.mark.parametrize("prequantize", [True, False])
def test_bound_chain_matches_repro(prequantize):
    """Two convs and two FCs bound with ``PALLAS_TILED`` at block 16 and
    chained on the wire format through the port's ``bind`` (the CPU
    versions of the x- and xw-prequant kernels and the epilogue) equal
    the same chain through ``repro``'s ``bind`` (emulated convs, Pallas
    matmuls in interpret mode), layer by layer."""
    params = _chain_params()
    x = normal((2, 8, 8, 16), seed=85, scale=2.0)
    jpol = J_TPU_TILED.with_(block_k=16, straight_through=False,
                             backend="pallas")
    jplan = JEG.bind(params, JPolicyMap.of(
        ("^c", jpol.with_(backend="emulated")), default=jpol), tree="cnn",
        strict=True, prequantize=prequantize)
    want = to_numpy_tree(jax.jit(lambda a: _run_chain(
        jplan, jplan.params, a, jnp))(x))
    plan = EG.bind(params_from_numpy(params, "cpu"), PALLAS16, tree="cnn",
                   strict=True, prequantize=prequantize, device="cpu")
    assert all(s.prequantized == prequantize for s in plan.sites.values())
    got = _run_chain(plan, plan.params, t(x), torch)
    assert [is_prequant(g) for g in got] == [True, True, True, False]
    for g, w_ in zip(got, want):
        _assert_wire_equal(g, w_)
    # the wire chain's end equals the float-activation chain's
    flt = t(x)
    for name, kind in _CHAIN:
        w = plan.params[name]["w"]
        if kind == "conv":
            flt = plan.conv2d(flt, w, path=name,
                              stride=1 if name == "c1" else 2)
        else:
            flt = plan.gemm(flt.reshape(flt.shape[0], -1), w, path=name)
    assert_bits_equal(got[-1], flt.numpy())


def test_cpu_wire_wrappers_take_the_plain_version(monkeypatch):
    def no_build(name):
        raise AssertionError("a CPU call must not build or load a kernel")
    monkeypatch.setattr(_build, "load", no_build)
    K.reset_launch_counts()
    pol = _pol(8, 8)
    xq = prequant_act(t(normal((3, 16), seed=91)), pol)
    w = t(normal((16, 8), seed=92))
    assert torch.equal(
        KM.bfp_matmul_xprequant(xq["m"], xq["s"], w, l_i=8, l_w=8, bk=8,
                                out_bits=8, out_block=8)[0],
        KM.bfp_matmul_xprequant_plain(xq["m"], xq["s"], w, 8, 8, 8, 8, 8)[0])
    xc = prequant_act(t(normal((1, 5, 5, 8), seed=93)), pol)
    wc = t(normal((3, 3, 8, 4), seed=94))
    assert torch.equal(
        KC.bfp_conv2d_xprequant(xc["m"], xc["s"], wc, l_i=8, l_w=8, bk=8),
        KC.bfp_conv2d_xprequant_plain(xc["m"], xc["s"], wc, 8, 8, 8))
    counts = K.launch_counts()
    assert set(counts.values()) == {0}
    assert {"bfp_matmul_xprequant", "bfp_matmul_xwprequant",
            "bfp_conv2d_xprequant", "bfp_conv2d_xwprequant",
            "bfp_matmul_epilogue", "bfp_conv2d_epilogue"} <= set(counts)


def test_wire_wrappers_check_the_wire_format():
    xq = prequant_act(t(normal((2, 32), seed=95)), _pol(8, 8))
    w = t(normal((32, 16), seed=96))
    with pytest.raises(ValueError, match="activation sidecar"):
        KM.bfp_matmul_xprequant(xq["m"], xq["s"][:, :3], w, l_i=8, l_w=8,
                                bk=8)
    with pytest.raises(ValueError, match="int8"):
        KM.bfp_matmul_xprequant(xq["m"].int(), xq["s"], w, l_i=8, l_w=8,
                                bk=8)
    with pytest.raises(ValueError, match="out_block"):
        KM.bfp_matmul_xprequant(xq["m"], xq["s"], w, l_i=8, l_w=8, bk=8,
                                out_bits=8, out_block=12)
    with pytest.raises(ValueError, match="out_bits"):
        KM.bfp_matmul(t(normal((2, 32), seed=97)), w, l_i=8, l_w=8, bk=8,
                      out_bits=10, out_block=8)
    xc = prequant_act(t(normal((1, 4, 4, 12), seed=98)), _pol(4, 8))
    with pytest.raises(ValueError, match="bk \\| C"):
        KC.bfp_conv2d_xprequant(xc["m"], xc["s"], t(normal((3, 3, 12, 4))),
                                l_i=8, l_w=8, bk=8)
