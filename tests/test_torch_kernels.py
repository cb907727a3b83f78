"""Port parity: the plain versions of the CUDA kernels against repro's
Pallas kernels (interpret mode), oracles and emulated engine (bit-exact).
The CUDA kernels are held against these plain versions on a card in
``test_torch_gpu.py``.

The Pallas conv kernel does not run on this JAX version (its
``pl.load`` is gone), so the conv versions are held against
``repro.kernels.ref.bfp_conv2d_ref`` and the emulated TILED engine,
which the reference documents as bit-identical to it.
"""
import jax
import numpy as np
import pytest
import torch

from repro import engine as JEG
from repro.core import prequant as jpq
from repro.core.policy import TPU_TILED as J_TPU_TILED
from repro.kernels import bfp_matmul as jbm
from repro.kernels import ops, ref
from repro_torch import kernels as K
from repro_torch.core.prequant import prequant_conv_leaf, prequant_leaf
from repro_torch.core.policy import TPU_TILED
from repro_torch.kernels import _build
from repro_torch.kernels import bfp_conv as KC
from repro_torch.kernels import bfp_matmul as KM
from repro_torch.kernels import ops as pops
from test_torch_util import (CONV_CASES, MM_CASES, assert_bits_equal,
                             conv_inputs, hazard_inputs, mm_inputs, pq_k, t,
                             to_numpy_tree)

@pytest.fixture(scope="module")
def mm_refs():
    """Reference GEMMs for every case in one compiled program: the
    oracle, the fused Pallas kernel (interpret) and its prequant
    variant on the reference's own sidecars."""
    def ref_fn(inputs):
        out = []
        for (x, w), (b, k, n, bk, L) in zip(inputs, MM_CASES):
            kp = -(-k // bk) * bk
            xp = jax.numpy.pad(x, ((0, 0), (0, kp - k)))
            wp = jax.numpy.pad(w, ((0, kp - k), (0, 0)))
            pol = J_TPU_TILED.with_(block_k=bk, l_i=L, l_w=L)
            kq = pq_k(k, bk)
            wq = jpq.prequant_leaf(w[:kq], pol.with_(l_w=8))
            out.append((ref.bfp_matmul_ref(xp, wp, L, L, bk),
                        ops.bfp_matmul(x, w, pol, interpret=True),
                        wq, ops.bfp_matmul_prequant(x[:, :kq], wq["m"],
                                                    wq["s"], pol.with_(l_w=8),
                                                    interpret=True)))
        return out
    return to_numpy_tree(jax.jit(ref_fn)([mm_inputs(c) for c in MM_CASES]))


@pytest.mark.parametrize("case", range(len(MM_CASES)))
def test_matmul_plain_matches_pallas_and_oracle(mm_refs, case):
    b, k, n, bk, L = MM_CASES[case]
    x, w = mm_inputs(MM_CASES[case])
    oracle, pallas, _, _ = mm_refs[case]
    got = KM.bfp_matmul_plain(t(x), t(w), L, L, bk)
    assert_bits_equal(got, oracle)
    assert_bits_equal(got, pallas)
    pol = TPU_TILED.with_(block_k=bk, l_i=L, l_w=L)
    assert_bits_equal(pops.bfp_matmul(t(x), t(w), pol), pallas)


@pytest.mark.parametrize("case", range(len(MM_CASES)))
def test_matmul_plain_in_tile_chunks_matches_pallas(mm_refs, case,
                                                    monkeypatch):
    """The plain datapath forms its tiles' partials ``PART_ELEMS`` at a
    time (a long contraction at a small block on the card): one and two
    tiles a chunk give the same bits as all at once."""
    b, k, n, bk, L = MM_CASES[case]
    x, w = mm_inputs(MM_CASES[case])
    _, pallas, _, _ = mm_refs[case]
    for tiles in (1, 2):
        monkeypatch.setattr(KM, "PART_ELEMS", tiles * b * n)
        assert_bits_equal(KM.bfp_matmul_plain(t(x), t(w), L, L, bk), pallas)


@pytest.mark.parametrize("case", range(len(MM_CASES)))
def test_matmul_prequant_plain_matches_pallas(mm_refs, case):
    b, k, n, bk, L = MM_CASES[case]
    x, w = mm_inputs(MM_CASES[case])
    _, _, wq, pallas = mm_refs[case]
    kq = pq_k(k, bk)
    mine = prequant_leaf(t(w[:kq]), TPU_TILED.with_(block_k=bk, l_w=8))
    assert_bits_equal(mine["m"], wq["m"])
    assert_bits_equal(mine["s"], wq["s"])
    got = KM.bfp_matmul_prequant_plain(t(x[:, :kq]), t(wq["m"]), t(wq["s"]),
                                       L, 8, bk)
    assert_bits_equal(got, pallas)
    pol = TPU_TILED.with_(block_k=bk, l_i=L)
    assert_bits_equal(pops.bfp_matmul_prequant(t(x[:, :kq]), mine["m"],
                                               mine["s"], pol), pallas)


@pytest.fixture(scope="module")
def conv_refs():
    """Oracle convs, and for bk | K the emulated TILED engine on the
    reference's prequant sidecars, in one compiled program."""
    def ref_fn(inputs):
        out = []
        for (x, w), (s, kk, pad, bk, L, c) in zip(inputs, CONV_CASES):
            o = ref.bfp_conv2d_ref(x, w, L, L, bk, s, pad)
            e = wq = None
            if (kk * kk * c) % bk == 0:
                pol = J_TPU_TILED.with_(block_k=bk, l_i=L, l_w=8,
                                        straight_through=False)
                wq = jpq.prequant_conv_leaf(w, pol)
                e = JEG.conv2d(x, wq, pol, stride=s, padding=pad)
            out.append((o, wq, e))
        return out
    return to_numpy_tree(jax.jit(ref_fn)(
        [conv_inputs(c) for c in CONV_CASES]))


@pytest.mark.parametrize("case", range(len(CONV_CASES)))
def test_conv_plain_matches_oracle(conv_refs, case):
    s, kk, pad, bk, L, c = CONV_CASES[case]
    x, w = conv_inputs(CONV_CASES[case])
    got = KC.bfp_conv2d_plain(t(x), t(w), L, L, bk, s, pad)
    assert_bits_equal(got, conv_refs[case][0])
    pol = TPU_TILED.with_(block_k=bk, l_i=L, l_w=L)
    assert_bits_equal(pops.bfp_conv2d(t(x), t(w), pol, s, pad),
                      conv_refs[case][0])


@pytest.mark.parametrize("case", [i for i, c in enumerate(CONV_CASES)
                                  if (c[1] * c[1] * c[5]) % c[3] == 0])
def test_conv_prequant_plain_matches_emulated_engine(conv_refs, case):
    s, kk, pad, bk, L, c = CONV_CASES[case]
    x, w = conv_inputs(CONV_CASES[case])
    _, wq, emulated = conv_refs[case]
    mine = prequant_conv_leaf(t(w), TPU_TILED.with_(block_k=bk))
    assert_bits_equal(mine["m"], wq["m"])
    assert_bits_equal(mine["s"], wq["s"])
    got = KC.bfp_conv2d_prequant_plain(t(x), t(wq["m"]), t(wq["s"]), L, 8,
                                       bk, s, pad)
    assert_bits_equal(got, emulated)
    pol = TPU_TILED.with_(block_k=bk, l_i=L)
    assert_bits_equal(pops.bfp_conv2d_prequant(t(x), mine["m"], mine["s"],
                                               pol, s, pad), emulated)


def test_overflow_guard_matches_reference():
    for bk, l_sum in ((1 << 17, 16), (1 << 9, 24), (2, 32)):
        with pytest.raises(ValueError, match="overflows int32"):
            jbm._check_tiles(8, bk, 8, 8, 8, bk, l_sum)
        with pytest.raises(ValueError, match="overflows int32"):
            KM.check_overflow(bk, l_sum)
    KM.check_overflow(1 << 16, 16)                # the largest admitted
    x, w = torch.ones(2, 1 << 9), torch.ones(1 << 9, 3)
    with pytest.raises(ValueError, match="overflows int32"):
        KM.bfp_matmul(x, w, l_i=12, l_w=12, bk=1 << 9)
    with pytest.raises(ValueError, match="overflows int32"):
        KC.bfp_conv2d(torch.ones(1, 4, 4, 64), torch.ones(3, 3, 64, 2),
                      l_i=12, l_w=12, bk=576)


def test_halfway_nan_and_zero_blocks_match_pallas():
    """Ties round half to even and a NaN block is zeroed, as in the
    Pallas kernel (the subnormal row is left out: XLA:CPU flushes it)."""
    x, w = hazard_inputs()
    rows = [0, 1, 3, 4]
    pol = J_TPU_TILED.with_(block_k=32)
    want = np.asarray(jax.jit(lambda a, b: ops.bfp_matmul(
        a, b, pol, interpret=True))(x[rows], w))
    got = KM.bfp_matmul_plain(t(x[rows]), t(w), 8, 8, 32)
    assert_bits_equal(got, want)
    assert np.isfinite(want).all()


def test_subnormal_amax_takes_the_exponent_field():
    """The kernels read floor(log2 amax) from the f32 exponent field, so
    a subnormal amax gives -127 (``core.bfp.block_exponent`` uses frexp
    instead, as in ``repro``).  numpy keeps IEEE subnormals, so it is the
    oracle here; XLA:CPU would flush these operands to zero."""
    tile = np.array([[1e-40, -3e-41, 2e-45, 0.0]], np.float32)
    m, step = KM.block_format(t(tile), 8, dim=1)
    want_step = np.float32(2.0 ** (-127 - 6))
    assert step.item() == want_step
    assert_bits_equal(m, np.clip(np.round(tile / want_step), -127, 127))
    assert_bits_equal(KM._floor_log2(t(np.abs(tile).max(1, keepdims=True))),
                      np.array([[-127]], np.int32))


def test_wrappers_check_the_wire_format():
    x = torch.ones(2, 32)
    with pytest.raises(ValueError, match="contraction"):
        KM.bfp_matmul(x, torch.ones(16, 4), l_i=8, l_w=8, bk=8)
    with pytest.raises(ValueError, match="sidecar"):
        KM.bfp_matmul_prequant(x, torch.ones(32, 4, dtype=torch.int8),
                               torch.ones(3, 4), l_i=8, l_w=8, bk=8)
    with pytest.raises(ValueError, match="int8"):
        KM.bfp_matmul_prequant(x, torch.ones(32, 4, dtype=torch.int16),
                               torch.ones(4, 4), l_i=8, l_w=8, bk=8)
    with pytest.raises(ValueError, match="channel"):
        KC.bfp_conv2d(torch.ones(1, 4, 4, 3), torch.ones(3, 3, 4, 2),
                      l_i=8, l_w=8, bk=8)
    with pytest.raises(ValueError, match="stride"):
        KC.bfp_conv2d(torch.ones(1, 4, 4, 3), torch.ones(3, 3, 3, 2),
                      l_i=8, l_w=8, bk=8, stride=0)
    with pytest.raises(ValueError, match="policy.block_k"):
        pops.bfp_matmul_prequant(x, torch.ones(32, 4, dtype=torch.int8),
                                 torch.ones(4, 4),
                                 TPU_TILED.with_(block_k=16))
    # block_k=None: repro's defaults (the fallback K tile for a GEMM,
    # whole-K for a conv); a whole-K block over the int32 guard raises
    assert torch.equal(
        pops.bfp_matmul(x, torch.ones(32, 4), TPU_TILED.with_(block_k=None)),
        KM.bfp_matmul_plain(x, torch.ones(32, 4), 8, 8, 32))
    with pytest.raises(ValueError, match="overflows int32"):
        pops.bfp_conv2d(torch.ones(1, 4, 4, 64), torch.ones(3, 3, 64, 2),
                        TPU_TILED.with_(block_k=None, l_i=12, l_w=12))


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    def no_build(name):
        raise AssertionError("a CPU call must not build or load a kernel")
    monkeypatch.setattr(_build, "load", no_build)
    K.reset_launch_counts()
    x, w = torch.randn(3, 16), torch.randn(16, 5)
    assert torch.equal(KM.bfp_matmul(x, w, l_i=8, l_w=8, bk=8),
                       KM.bfp_matmul_plain(x, w, 8, 8, 8))
    xc, wc = torch.randn(1, 5, 5, 2), torch.randn(3, 3, 2, 4)
    assert torch.equal(KC.bfp_conv2d(xc, wc, l_i=8, l_w=8, bk=6),
                       KC.bfp_conv2d_plain(xc, wc, 8, 8, 6))
    assert set(K.launch_counts().values()) == {0}
