"""The f32-output BFP matmuls as the int8 mma core computes them: a 1x1
conv over x viewed as ``[1, B, 1, K]``.

On the card ``bfp_matmul_prequant`` (f32 out, L <= 8, a power-of-two
block from 32 to 512, N % 4 == 0) runs the prequant conv's activation
format pass on x and then the core, and ``bfp_matmul`` (float weights)
runs the inline conv's patch format pass and then the core, each as the
1x1, stride-1, VALID conv.  Here those compositions of plain versions
are held bit-equal to ``bfp_matmul_prequant_plain`` and
``bfp_matmul_plain`` at B 1, 8 and 17, K 64 to 25088 (ragged K for the
inline matmul), N 12, 64 and 1000, bk 32, 128 and 512, L 4 and 8, with a
zero row, a zero block, a NaN, an inf and a subnormal-amax row among the
inputs and an inf weight (or weight step).  On finite inputs both are
held bit-equal to ``repro``'s Pallas matmuls in interpret mode (XLA:CPU
flushes subnormals, so the oracle sees none).  The route rule
``matmul_core`` is pinned at the served shapes.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import prequant as jpq
from repro.core.policy import TPU_TILED as J_TPU_TILED
from repro.kernels import ops
from repro_torch import kernels as K
from repro_torch.core.policy import TPU_TILED
from repro_torch.core.prequant import prequant_leaf
from repro_torch.kernels import _build
from repro_torch.kernels import bfp_conv as KC
from repro_torch.kernels import bfp_matmul as KM
from test_torch_util import assert_bits_equal, normal, t, to_numpy_tree

# (B, K, N, bk, L); prequant: bk | K
PQ_CASES = [(1, 64, 12, 32, 4), (8, 2048, 1000, 128, 8),
            (17, 2048, 64, 512, 8), (8, 25088, 64, 128, 8),
            (17, 2048, 12, 32, 4), (8, 25088, 12, 512, 4)]
# inline: K ragged as well
INLINE_CASES = [(8, 64, 64, 128, 8), (17, 300, 12, 32, 4),
                (1, 2047, 64, 32, 8), (8, 2048, 1000, 512, 4),
                (17, 2047, 1000, 128, 8), (8, 25088, 64, 128, 8)]
PQ_IDS = [f"B{b}-K{k}-N{n}-bk{bk}-L{L}" for b, k, n, bk, L in PQ_CASES]
INLINE_IDS = [f"B{b}-K{k}-N{n}-bk{bk}-L{L}"
              for b, k, n, bk, L in INLINE_CASES]


def _x(case, hazards):
    """x [B, K]; with ``hazards`` (B > 1) row 0 is zero but for a
    NaN, row 1 holds a zero block, an inf and a x1000 block, and the
    last row is subnormal throughout.  B = 1: one zero block and one
    subnormal block."""
    b, k, _, bk, L = case
    x = normal((b, k), seed=b * k + L)
    if not hazards:
        return x
    if b == 1:
        x[0, :bk] = 0.0
        x[0, bk:2 * bk] = np.float32(1e-40)
        return x
    x[0] = 0.0
    x[0, k // 2] = np.nan
    x[1, :bk] = 0.0
    x[1, k - 1] = np.inf
    x[1, bk:2 * bk] *= 1000.0
    x[-1] = np.float32(1e-40) * np.sign(x[-1])
    return x


def _w(case, inf_weight):
    _, k, n, _, _ = case
    w = normal((k, n), seed=k + n, scale=0.05)
    w[:, 2] = 0.0                                  # all-zero w blocks
    if inf_weight:
        w[k // 3, 1] = np.inf
    return w


def _pq(w, bk):
    return prequant_leaf(w, TPU_TILED.with_(block_k=bk, l_w=8))


def _xformat_route(x, wm, ws, L, bk):
    """The prequant matmul's route: the activation format pass over
    [1, B, 1, K], then the wire-format 1x1 conv -> [B, N]."""
    b, k = x.shape
    n = wm.shape[1]
    xm, xs = KC.bfp_conv2d_xformat_plain(x.reshape(1, b, 1, k), L, bk)
    out = KC.bfp_conv2d_xwprequant_plain(xm, xs, wm.reshape(1, 1, k, n), ws,
                                         L, 8, bk, 1, "VALID")
    return out.reshape(b, n)


def _pformat_route(x, w, L, bk):
    """The inline matmul's route: the patch format pass over [1, B, 1, K]
    and [1, 1, K, N], then the wire-format 1x1 conv over [1, B, 1, Kp]."""
    b, k = x.shape
    n = w.shape[1]
    xm, xs, wm, ws = KC.bfp_conv2d_pformat_plain(
        x.reshape(1, b, 1, k), w.reshape(1, 1, k, n), L, L, bk, 1, "VALID")
    kp = xm.shape[1]
    out = KC.bfp_conv2d_xwprequant_plain(
        xm.reshape(1, b, 1, kp), xs.reshape(1, b, 1, kp // bk),
        wm.reshape(1, 1, kp, n), ws, L, L, bk, 1, "VALID")
    return out.reshape(b, n)


@pytest.mark.parametrize("i", range(len(PQ_CASES)), ids=PQ_IDS)
def test_format_pass_then_core_equals_the_prequant_matmul(i):
    b, k, n, bk, L = case = PQ_CASES[i]
    x = t(_x(case, True))
    d = _pq(t(_w(case, False)), bk)
    d["s"][-1, 1] = float("inf")                   # an inf weight step
    want = KM.bfp_matmul_prequant_plain(x, d["m"], d["s"], L, 8, bk)
    if b > 1:
        assert not bool(torch.isfinite(want).all())  # hazards reach sums
    assert_bits_equal(_xformat_route(x, d["m"], d["s"], L, bk),
                      want.numpy())


@pytest.mark.parametrize("i", range(len(INLINE_CASES)), ids=INLINE_IDS)
def test_patch_format_then_core_equals_the_inline_matmul(i):
    b, k, n, bk, L = case = INLINE_CASES[i]
    x, w = t(_x(case, True)), t(_w(case, True))
    want = KM.bfp_matmul_plain(x, w, L, L, bk)
    assert not bool(torch.isfinite(want).all())
    assert_bits_equal(_pformat_route(x, w, L, bk), want.numpy())


def test_subnormal_and_zero_rows_format_as_the_tile_kernel_does():
    """The blocks the format pass hands the core: a zero row takes the
    zero-block step 2^-(126 + L-2), a subnormal-amax row exponent -127,
    a NaN block is zeroed with the zero step, an inf block takes
    exponent 128 (the tile kernel's block rules)."""
    b, k, n, bk, L = case = (4, 96, 8, 32, 8)
    x = t(_x(case, True))
    xm, xs = KC.bfp_conv2d_xformat_plain(x.reshape(1, b, 1, k), L, bk)
    xm, xs = xm.reshape(b, k), xs.reshape(b, k // bk)
    zero = np.float32(2.0) ** np.float32(-126 - (L - 2))
    assert bool((xs[0, [0, 2]] == zero).all())   # zero blocks of row 0
    assert xs[0, 1] == zero and not xm[0].any()   # its NaN block: zeroed
    assert xs[1, 0] == zero and not xm[1, :bk].any()
    assert xs[1, 2] == np.float32(2.0) ** np.float32(128 - (L - 2))
    sub = np.float32(2.0) ** np.float32(-127 - (L - 2))
    assert bool((xs[-1] == sub).all())


# small shapes for the interpret-mode oracle (B, K, N, bk, L); bk | K
ORACLE_CASES = [(3, 96, 12, 32, 8), (8, 256, 64, 128, 4),
                (1, 512, 20, 512, 8)]


@pytest.fixture(scope="module")
def pallas():
    """``repro``'s Pallas matmuls (interpret mode, through ops' padding)
    on finite inputs, one compiled program: the inline kernel on float
    weights, the prequant kernel on the reference's own sidecars."""
    def ref_fn(inputs):
        out = []
        for (x, w), (_, _, _, bk, L) in zip(inputs, ORACLE_CASES):
            pol = J_TPU_TILED.with_(block_k=bk, l_i=L, l_w=L)
            wq = jpq.prequant_leaf(w, pol.with_(l_w=8))
            out.append((ops.bfp_matmul(x, w, pol, interpret=True), wq,
                        ops.bfp_matmul_prequant(x, wq["m"], wq["s"],
                                                pol.with_(l_w=8),
                                                interpret=True)))
        return out
    return to_numpy_tree(jax.jit(ref_fn)(
        [(_x(c, False), _w(c, False)) for c in ORACLE_CASES]))


@pytest.mark.parametrize("i", range(len(ORACLE_CASES)))
def test_both_routes_match_the_pallas_matmuls(pallas, i):
    _, _, _, bk, L = case = ORACLE_CASES[i]
    x, w = t(_x(case, False)), t(_w(case, False))
    inline, wq, prequant = pallas[i]
    mine = _pq(w, bk)
    assert_bits_equal(mine["m"], wq["m"])
    assert_bits_equal(mine["s"], wq["s"])
    got = _pformat_route(x, w, L, bk)
    assert bool(torch.isfinite(got).all())
    assert_bits_equal(got, inline)
    assert_bits_equal(_xformat_route(x, mine["m"], mine["s"], L, bk),
                      prequant)


# (layer, prequant, K, N) of the served GEMMs at block 128, L 8: VGG16
# fc6-8, the ResNet fcs, GoogLeNet's fc and its two loss heads' fc1/fc2,
# and reduced VGG16's fc6/fc7 (float weights, K = 64)
SERVED_GEMMS = [("vgg16/fc6", True, 25088, 4096),
                ("vgg16/fc7", True, 4096, 4096),
                ("vgg16/fc8", True, 4096, 1000),
                ("resnet50/fc", True, 2048, 1000),
                ("resnet18/fc", True, 512, 1000),
                ("googlenet/fc", True, 1024, 1000),
                ("googlenet/loss_fc1", True, 2048, 1024),
                ("googlenet/loss_fc2", True, 1024, 1000),
                ("vgg16_reduced/fc6", False, 64, 64),
                ("vgg16_reduced/fc7", False, 64, 64)]


@pytest.mark.parametrize("layer,prequant,k,n", SERVED_GEMMS,
                         ids=[s[0] for s in SERVED_GEMMS])
def test_served_gemms_take_the_mma_core(layer, prequant, k, n):
    assert KM.matmul_core(prequant, 128, k, n, 8, 8) == "mma"


def test_matmul_route_rule_keeps_the_rest_on_the_tile_kernel():
    assert KM.matmul_core(False, 128, 64, 10, 8, 8) == "tile"  # reduced fc8
    # an epilogue whose blocks the output format pass cannot load (4 | ob)
    assert KM.matmul_core(True, 128, 2048, 1000, 8, 8, 8, 2) == "tile"
    assert KM.matmul_core(False, 128, 64, 64, 8, 8, 8, 2) == "tile"
    assert KM.matmul_core(True, 128, 2048, 1000, 12, 8) == "tile"  # L 12
    assert KM.matmul_core(False, 128, 64, 64, 8, 12) == "tile"
    assert KM.matmul_core(False, 8, 64, 64, 8, 8) == "tile"      # bk 8
    assert KM.matmul_core(True, 96, 2016, 64, 8, 8) == "tile"    # not 2^n
    assert KM.matmul_core(True, 1024, 2048, 64, 8, 8) == "tile"  # > 512
    # Kp * N past the int32 indexing, and more column blocks than a grid
    # holds (the tile kernel runs both)
    assert KM.matmul_core(True, 128, 1 << 20, 4096, 8, 8) == "tile"
    assert KM.matmul_core(False, 32, 32, 32 * 65536, 8, 8) == "tile"
    assert KM.matmul_core(False, 32, 32, 32 * 65535, 8, 8) == "mma"
    # ragged K takes the core with float weights (the pass pads it)
    assert KM.matmul_core(False, 32, 2047, 64, 8, 8) == "mma"


def test_cpu_matmuls_take_the_plain_version(monkeypatch):
    def no_build(name):
        raise AssertionError("a CPU call must not build or load a kernel")
    monkeypatch.setattr(_build, "load", no_build)
    K.reset_launch_counts()
    case = (8, 256, 64, 128, 8)
    x, w = t(_x(case, False)), t(_w(case, False))
    d = _pq(w, 128)
    assert KM.matmul_core(True, 128, 256, 64, 8, 8) == "mma"
    assert torch.equal(KM.bfp_matmul(x, w, l_i=8, l_w=8, bk=128),
                       KM.bfp_matmul_plain(x, w, 8, 8, 128))
    assert torch.equal(
        KM.bfp_matmul_prequant(x, d["m"], d["s"], l_i=8, l_w=8, bk=128),
        KM.bfp_matmul_prequant_plain(x, d["m"], d["s"], 8, 8, 128))
    counts = K.launch_counts()
    assert set(counts.values()) == {0}
    assert {"bfp_matmul_xformat", "bfp_matmul_pformat"} <= set(counts)
