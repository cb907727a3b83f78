"""The served weight-prequant conv as the int8 mma core computes it: the
activation format pass, then the conv on both wire operands.

On the card ``bfp_conv2d_prequant`` block-formats x once per (pixel,
channel chunk) and runs the xw-prequant core; its plain version formats
each patch K-tile inline.  Here the plain format pass followed by
``bfp_conv2d_xwprequant_plain`` is held bit-equal to
``bfp_conv2d_prequant_plain`` (3x3 and 1x1, stride 1 and 2, SAME and
VALID, bk 32 and 128, L 4 and 8), with zero, NaN, inf and subnormal-amax
pixel chunks and an inf weight block among the inputs: outside the image
the core reads mantissa 0 and step 1.0 where the inline route formats a
zero block, and the two agree term by term (0 * (sx*sw) is +-0 for a
finite weight step and NaN for an inf one either way).  On finite inputs
both are also held bit-equal to ``repro.kernels.ref.bfp_conv2d_ref`` (the
Pallas conv does not run on this JAX, R1; XLA:CPU flushes subnormals, so
the oracle sees no subnormal chunk).  The core's choice and tiles are
pure functions of shape and policy, pinned at the served shapes.
"""
import jax
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro_torch.core.policy import TPU_TILED
from repro_torch.core.prequant import prequant_conv_leaf
from repro_torch.kernels import bfp_conv as KC
from repro_torch.kernels import bfp_matmul as KM
from test_torch_util import assert_bits_equal, normal, t, to_numpy_tree

# (kernel, stride, padding, bk, L, C)
CASES = [(3, 1, "SAME", 32, 8, 64), (3, 2, "SAME", 32, 4, 32),
         (3, 1, "VALID", 128, 8, 128), (3, 2, "VALID", 32, 8, 96),
         (1, 1, "SAME", 128, 4, 256), (1, 2, "SAME", 32, 8, 64),
         (1, 2, "VALID", 128, 8, 128)]
IDS = [f"{k}x{k}-s{s}-{p}-bk{bk}-L{L}" for k, s, p, bk, L, _ in CASES]


def _x(case, hazards):
    """NHWC x [2, 7, 6, C]; with ``hazards`` one zero, one NaN, one inf
    and one subnormal-amax pixel chunk (all in image 0)."""
    k, s, _, bk, L, c = case
    x = normal((2, 7, 6, c), seed=k * c + s + L)
    if hazards:
        x[0, 0, 0, :bk] = 0.0
        x[0, 1, 2, 3] = np.nan
        x[0, 3, 1, bk - 1] = np.inf
        x[0, 6, 5, :bk] = np.float32(1e-40) * np.sign(normal(bk, seed=c))
        x[0, 4, 4, :bk] *= 1000.0
    return x


def _w(case):
    k, _, _, bk, _, c = case
    return normal((k, k, c, 12), seed=c + k, scale=0.1)


def _sidecar(case, inf_block):
    """Prequant weight (L_W = 8); with ``inf_block`` one weight element is
    inf (its block saturates) and one step of the sidecar is inf."""
    w = _w(case)
    if inf_block:
        w[0, 0, 1, 2] = np.inf
    d = prequant_conv_leaf(t(w), TPU_TILED.with_(block_k=case[3]))
    if inf_block:
        d["s"][-1, 5] = float("inf")
    return d


def _two_routes(case, x, d):
    k, s, pad, bk, L, _ = case
    xm, xs = KC.bfp_conv2d_xformat_plain(x, L, bk)
    inline = KC.bfp_conv2d_prequant_plain(x, d["m"], d["s"], L, 8, bk, s,
                                          pad)
    core = KC.bfp_conv2d_xwprequant_plain(xm, xs, d["m"], d["s"], L, 8, bk,
                                          s, pad)
    return inline, core


@pytest.fixture(scope="module")
def oracle():
    def ref_fn(ops):
        return [ref.bfp_conv2d_ref(x, w, c[4], 8, c[3], c[1], c[2])
                for c, (x, w) in zip(CASES, ops)]
    return to_numpy_tree(jax.jit(ref_fn)(
        [(_x(c, False), _w(c)) for c in CASES]))


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_format_then_wire_conv_equals_inline_prequant_conv(i):
    case = CASES[i]
    inline, core = _two_routes(case, t(_x(case, True)),
                               _sidecar(case, True))
    assert not bool(torch.isfinite(inline).all())  # hazards reach the sums
    assert_bits_equal(core, inline.numpy())


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_both_routes_match_the_reference_oracle(oracle, i):
    case = CASES[i]
    inline, core = _two_routes(case, t(_x(case, False)),
                               _sidecar(case, False))
    assert bool(torch.isfinite(core).all())
    assert_bits_equal(inline, oracle[i])
    assert_bits_equal(core, oracle[i])


@pytest.mark.parametrize("bk,L", [(32, 8), (128, 4), (64, 6)])
def test_format_pass_is_the_kernels_block_rule(bk, L):
    """One block per (pixel, chunk): the requantize epilogue's rule on
    the channel axis, not ``prequant_act``'s frexp: a NaN chunk is zeroed
    with the zero-block step, an inf chunk takes exponent 128, a
    subnormal amax exponent -127."""
    x = _x((3, 1, "SAME", bk, L, 2 * bk), True)
    xm, xs = KC.bfp_conv2d_xformat(t(x), l_i=L, bk=bk)
    assert xm.dtype == torch.int8 and xm.shape == x.shape
    assert xs.shape == (2, 7, 6, 2)
    want_m, want_s = KM.requant_plain(t(x), L, bk)
    assert_bits_equal(xm, want_m.numpy())
    assert_bits_equal(xs, want_s.numpy())
    pow2 = lambda e: np.float32(2.0) ** np.float32(e)  # noqa: E731
    assert xs[0, 1, 2, 0] == pow2(-126 - (L - 2)) and \
        not xm[0, 1, 2, :bk].any()                       # NaN chunk
    assert xs[0, 3, 1, (bk - 1) // bk] == pow2(128 - (L - 2))  # inf chunk
    assert xs[0, 6, 5, 0] == np.float32(2.0 ** (-127 - (L - 2)))
    assert xs[0, 0, 0, 0] == pow2(-126 - (L - 2))        # zero chunk
    # every finite chunk reconstructs within one step (half a step, or
    # the clamp at +-lim for the chunk's largest element)
    fin = np.isfinite(x).reshape(2, 7, 6, 2, bk).all(-1)
    deq = (xm.double().reshape(2, 7, 6, 2, bk) * xs.double()[..., None])
    err = np.abs(deq.numpy()[fin] - x.reshape(2, 7, 6, 2, bk)[fin]).max(-1)
    assert (err <= xs.numpy()[fin]).all()


def test_format_pass_refuses_what_it_cannot_format():
    with pytest.raises(ValueError, match="bk | C"):
        KC.bfp_conv2d_xformat(torch.ones(1, 2, 2, 48), l_i=8, bk=32)
    with pytest.raises(ValueError, match="int8"):
        KC.bfp_conv2d_xformat(torch.ones(1, 2, 2, 64), l_i=12, bk=32)


# (M, N, expected tile) of served prequant convs at batch 8, block 128
SERVED = [(392, 512, (32, 32)),      # ResNet-50/18 stage 4 (3x3, 1x1 in)
          (392, 2048, (32, 64)),     # ResNet-50 stage 4 1x1 out
          (1568, 512, (32, 64)),     # VGG16 conv5_x
          (6272, 512, (64, 128)),    # VGG16 conv4_x
          (25088, 256, (64, 128)),   # VGG16 conv3_x
          (25088, 64, (32, 64)),     # ResNet-50 stage 1, 1x1 256 -> 64
          (1568, 24, (16, 32))]      # GoogLeNet inception 4c, 1x1 -> 24


@pytest.mark.parametrize("m,n,tile", SERVED)
def test_mma_tile_fills_the_card_at_served_shapes(m, n, tile):
    bm, bn = KC.MMA_TILES[KC.mma_tile(m, n, 128)]
    assert (bm, bn) == tile
    blocks = -(-m // bm) * -(-n // bn)
    assert blocks >= 132 or (bm, bn) == KC.MMA_TILES[-1]


def test_mma_tile_keeps_shared_memory_within_a_block():
    # the 64x128 tile stages up to bk = 256; bk = 512 takes 32x64
    assert KC.MMA_TILES[KC.mma_tile(6272, 512, 256)] == (64, 128)
    assert KC.MMA_TILES[KC.mma_tile(6272, 512, 512)] == (32, 64)


def test_core_choice_is_a_pure_function_of_shape_and_policy():
    # the served prequant convs: block 128 divides C, f32 out, L 8
    assert KC.conv_core(False, True, 128, 512, 512, 8) == "mma"
    assert KC.conv_core(True, True, 128, 256, 256, 8) == "mma"
    # the inline conv, after its patch format pass (no bk | C needed)
    assert KC.conv_core(False, False, 128, 512, 512, 8) == "mma"
    assert KC.conv_core(False, False, 128, 64, 512, 8) == "mma"
    # the x-prequant conv, after its weight format pass, and the epilogue
    # after the core (an out_block that is a multiple of 4)
    assert KC.conv_core(True, False, 128, 512, 512, 8) == "mma"    # x-pq
    assert KC.conv_core(False, True, 128, 512, 512, 8, 8, 8, 32) == "mma"
    # what stays on the tile kernel
    assert KC.conv_core(False, True, 128, 512, 512, 8, 8, 8, 2) == "tile"
    assert KC.conv_core(False, True, 128, 512, 512, 12) == "tile"  # WIDE
    assert KC.conv_core(True, True, 128, 512, 512, 12) == "mma"   # wire x
    assert KC.conv_core(False, True, 48, 96, 512, 8) == "tile"    # bk%32
    assert KC.conv_core(False, True, 96, 192, 512, 8) == "tile"   # not 2^n
    assert KC.conv_core(False, True, 1024, 1024, 512, 8) == "tile"  # > 512
    assert KC.conv_core(False, True, 128, 64, 512, 8) == "tile"   # bk ∤ C
    assert KC.conv_core(False, True, 128, 512, 30, 8) == "tile"   # OC % 4
