"""The inline-weight conv as the int8 mma core computes it: the patch
format pass, then the core as a 1x1 conv over the patch matrix.

On the card ``bfp_conv2d`` (f32 out, L <= 8, a power-of-two block from 32
to 512, OC % 4 == 0) block-formats the im2col patch matrix once per
(row, K-tile) and the float weight once per (K-tile, column) with the
tile kernel's rules, then runs the xw-prequant core on ``[1, M, 1, Kp]``
as a 1x1, stride-1, unpadded conv.  Here the plain format pass followed
by ``bfp_conv2d_xwprequant_plain`` on that shape is held bit-equal to
``bfp_conv2d_plain`` (3x3, 5x5, 7x7/2 and 1x1, SAME and VALID, K = 27,
147, 400 and 576, bk 32 and 128, L 4 and 8), with zero, NaN, inf and
subnormal-amax blocks, K-tiles wholly outside the image and an inf
weight among the inputs.  On finite inputs both are also held bit-equal
to ``repro.kernels.ref.bfp_conv2d_ref`` (the Pallas conv does not run on
this JAX, R1; XLA:CPU flushes subnormals, so the oracle sees none).  The
route rule is pinned at the served shapes.
"""
import jax
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro_torch.core.conv_utils import im2col
from repro_torch.core.policy import TPU_TILED
from repro_torch.core.prequant import prequant_conv_leaf
from repro_torch.kernels import bfp_conv as KC
from test_torch_util import assert_bits_equal, normal, t, to_numpy_tree

# (kernel, stride, padding, bk, L, C, OC); x is [2, 7, 6, C]
CASES = [(3, 1, "SAME", 32, 8, 3, 8),       # K = 27 (conv1_1)
         (7, 2, "SAME", 128, 8, 3, 16),     # K = 147, the stem
         (7, 2, "SAME", 32, 4, 3, 8),       # its corner K-tiles outside
         (5, 1, "SAME", 32, 4, 16, 24),     # K = 400
         (3, 1, "SAME", 128, 4, 64, 12),    # K = 576 (C = 64)
         (3, 2, "VALID", 32, 8, 64, 8),
         (1, 1, "SAME", 128, 8, 192, 16),   # 1x1, bk does not divide C
         (1, 2, "VALID", 32, 4, 48, 4)]
IDS = [f"{k}x{k}-s{s}-{p}-K{k * k * c}-bk{bk}-L{L}"
       for k, s, p, bk, L, c, _ in CASES]


def _x(case, hazards):
    """NHWC x [2, 7, 6, C]; with ``hazards`` image 0 holds a zero pixel,
    a NaN and an inf in two corners (so that most blocks stay free of
    the NaN) and a pixel scaled by 1000, and image 1 is subnormal
    throughout (every block of it has a subnormal amax)."""
    k, s, _, bk, L, c, _ = case
    x = normal((2, 7, 6, c), seed=k * c + s + L)
    if hazards:
        x[0, 0, 0, :] = 0.0
        x[0, 0, 1, c // 2] = np.nan
        x[0, 6, 5, c - 1] = np.inf
        x[0, 3, 3, :] *= 1000.0
        x[1] = np.float32(1e-40) * np.sign(x[1])
    return x


def _w(case, inf_weight):
    k, _, _, _, _, c, oc = case
    w = normal((k, k, c, oc), seed=c + k + oc, scale=0.1)
    if inf_weight:
        w[0, 0, 0, 1] = np.inf
    return w


def _core_route(x, w, case):
    """The patch format pass, then the wire-format conv over
    [1, M, 1, Kp] (the core's 1x1 view) -> NHWC."""
    k, s, pad, bk, L, _, oc = case
    xm, xs, wm, ws = KC.bfp_conv2d_pformat_plain(x, w, L, L, bk, s, pad)
    m, kp = xm.shape
    out = KC.bfp_conv2d_xwprequant_plain(
        xm.reshape(1, m, 1, kp), xs.reshape(1, m, 1, kp // bk),
        wm.reshape(1, 1, kp, oc), ws, L, L, bk, 1, "VALID")
    inline = KC.bfp_conv2d_plain(x, w, L, L, bk, s, pad)
    return out.reshape(inline.shape), inline


@pytest.fixture(scope="module")
def oracle():
    def ref_fn(ops):
        return [ref.bfp_conv2d_ref(x, w, c[4], c[4], c[3], c[1], c[2])
                for c, (x, w) in zip(CASES, ops)]
    return to_numpy_tree(jax.jit(ref_fn)(
        [(_x(c, False), _w(c, False)) for c in CASES]))


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_patch_format_then_core_equals_the_inline_conv(i):
    case = CASES[i]
    core, inline = _core_route(t(_x(case, True)), t(_w(case, True)), case)
    assert not bool(torch.isfinite(inline).all())  # hazards reach the sums
    assert_bits_equal(core, inline.numpy())


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_both_routes_match_the_reference_oracle(oracle, i):
    case = CASES[i]
    core, inline = _core_route(t(_x(case, False)), t(_w(case, False)), case)
    assert bool(torch.isfinite(core).all())
    assert_bits_equal(inline, oracle[i])
    assert_bits_equal(core, oracle[i])


def _pow2(e):
    return np.float32(2.0) ** np.float32(e)


@pytest.mark.parametrize("L", [4, 8])
def test_patch_blocks_are_the_tile_kernels_blocks(L):
    """Per (row, K-tile) of the HWIO-major patch row: a K-tile wholly
    outside the image and the K tail are zero blocks (step
    2^-(126 + L-2), mantissas 0), a NaN block is zeroed with that step,
    an inf block takes exponent 128, a subnormal amax exponent -127; the
    weight side is the prequant sidecar's format, zero-padded to Kp."""
    bk = 32
    case = (7, 2, "SAME", bk, L, 3, 8)
    x = t(_x(case, True))
    xm, xs, wm, ws = KC.bfp_conv2d_pformat(x, t(_w(case, False)), l_i=L,
                                           l_w=L, bk=bk, stride=2)
    assert (xm.dtype, xs.dtype, wm.dtype) == (torch.int8, torch.float32,
                                              torch.int8)
    # 2 x 4 x 3 output pixels; K = 147 -> Kp = 160, 5 K-tiles
    assert xm.shape == (24, 160) and xs.shape == (24, 5)
    assert wm.shape == (160, 8) and ws.shape == (5, 8)
    zero = _pow2(-126 - (L - 2))
    # pixel (0, 0): pad 3 above, so rows di = 0..2 (elements 0..62) are
    # outside and K-tile 0 (taps 0..10) lies wholly outside the image
    assert xs[0, 0] == zero and not xm[0, :bk].any()
    assert not xm[:, 147:].any()                      # the K tail
    # image 1 is subnormal: its blocks take exponent -127 or are zero
    sub = xs[12:]
    assert bool(((sub == np.float32(2.0 ** (-127 - (L - 2))))
                 | (sub == zero)).all())
    assert bool((sub == np.float32(2.0 ** (-127 - (L - 2)))).any())
    # blocks that read the NaN are zeroed; those that read the inf (and
    # no NaN) take exponent 128
    cols = torch.nn.functional.pad(im2col(x, 7, 7, 2, "SAME")[0],
                                   (0, 160 - 147)).reshape(24, 5, bk)
    nan_blk = torch.isnan(cols).any(-1)
    inf_blk = torch.isinf(cols).any(-1) & ~nan_blk
    assert nan_blk.any() and inf_blk.any()
    assert bool((xs[nan_blk] == zero).all())
    assert not xm.reshape(24, 5, bk)[nan_blk].any()
    assert bool((xs[inf_blk] == _pow2(128 - (L - 2))).all())
    # the weight side equals the prequant sidecar where bk | K
    w = t(_w((3, 1, "SAME", bk, L, 64, 8), False))
    _, _, wm2, ws2 = KC.bfp_conv2d_pformat(torch.zeros(1, 3, 3, 64), w,
                                           l_i=L, l_w=8, bk=bk)
    d = prequant_conv_leaf(w, TPU_TILED.with_(block_k=bk))
    assert_bits_equal(wm2, d["m"].reshape(576, 8).numpy())
    assert_bits_equal(ws2, d["s"].numpy())


def test_patch_format_pass_refuses_what_it_cannot_format():
    x, w = torch.ones(1, 4, 4, 3), torch.ones(3, 3, 3, 4)
    with pytest.raises(ValueError, match="int8"):
        KC.bfp_conv2d_pformat(x, w, l_i=12, l_w=8, bk=32)
    for bk in (16, 48, 1024):
        with pytest.raises(ValueError, match="power-of-two bk"):
            KC.bfp_conv2d_pformat(x, w, l_i=8, l_w=8, bk=bk)


# (layer, C, OC) of served inline convs at block 128, L 8: VGG16
# conv1_1..conv2_1, the ResNet stem and stage-1 convs, GoogLeNet's stem
# and inception 3a
SERVED_INLINE = [("vgg16/conv1_1", 3, 64), ("vgg16/conv1_2", 64, 64),
                 ("vgg16/conv2_1", 64, 128), ("resnet/stem", 3, 64),
                 ("resnet50/s1_1x1_in", 64, 64), ("resnet/s1_3x3", 64, 64),
                 ("resnet50/s1_1x1_out", 64, 256),
                 ("googlenet/3a_b1", 192, 64), ("googlenet/3a_b3r", 192, 96),
                 ("googlenet/3a_b3", 96, 128), ("googlenet/3a_b5r", 192, 16),
                 ("googlenet/3a_b5", 16, 32), ("googlenet/3a_pool", 192, 32)]


@pytest.mark.parametrize("layer,c,oc", SERVED_INLINE,
                         ids=[s[0] for s in SERVED_INLINE])
def test_served_inline_convs_take_the_mma_core(layer, c, oc):
    assert KC.conv_core(False, False, 128, c, oc, 8, None, 8) == "mma"
    assert KC.patch_core(128, oc, None, 8, 8)


def test_inline_route_rule_keeps_the_rest_on_the_tile_kernel():
    # an epilogue whose blocks the output format pass cannot load (4 | ob)
    assert KC.conv_core(False, False, 128, 64, 64, 8, 8, 8, 2) == "tile"
    assert KC.conv_core(False, False, 128, 64, 64, 12, None, 8) == "tile"
    assert KC.conv_core(False, False, 128, 64, 64, 8, None, 12) == "tile"
    assert KC.conv_core(False, False, 96, 64, 64, 8) == "tile"   # not 2^n
    assert KC.conv_core(False, False, 16, 64, 64, 8) == "tile"   # < 32
    assert KC.conv_core(False, False, 1024, 64, 64, 8) == "tile"  # > 512
    assert KC.conv_core(False, False, 128, 64, 30, 8) == "tile"  # OC % 4
    # x-pq: the weight format pass needs L_W <= 8, the wire x bk | C
    assert KC.conv_core(True, False, 128, 128, 64, 8, None, 12) == "tile"
    assert KC.conv_core(True, False, 128, 64, 64, 8) == "tile"
    # whole-K (block_k=None) takes the core only where K is such a block
    assert KC.conv_core(False, False, 64, 64, 64, 8) == "mma"    # 1x1, K 64
    assert KC.conv_core(False, False, 576, 64, 64, 8) == "tile"  # 3x3x64
