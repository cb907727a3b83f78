"""``block_k=None`` at the kernels API: the port takes repro's defaults.

``repro.kernels.ops`` gives a GEMM the K tile of its fallback tile table
(``DEEP_K_BK`` for K >= 512, else the aligned tile of K, capped by the
int32 overflow bound) and a conv whole-K (kh*kw*C).  The port's
``kernels.ops`` does the same through its own ``tune.tables``.  Held bit
for bit: the port's ``ops.bfp_matmul`` against ``repro``'s in interpret
mode, and the port's ``ops.bfp_conv2d`` against
``repro.kernels.ref.bfp_conv2d_ref`` at bk = K (the Pallas conv does not
run on this JAX, R1).  A whole-K block over the int32 guard raises in
both packages.  The engine still refuses ``block_k=None`` on the kernel
backend, as ``repro``'s does.
"""
import itertools

import jax
import pytest
import torch

from repro.core.policy import TPU_TILED as J_TPU_TILED
from repro.kernels import ops as jops
from repro.kernels import ref
from repro.tune import tables as jtables
from repro_torch import engine as EG
from repro_torch.core.policy import TPU_TILED
from repro_torch.kernels import ops
from repro_torch.tune import tables
from test_torch_util import assert_bits_equal, normal, t, to_numpy_tree

NONE = TPU_TILED.with_(block_k=None)
J_NONE = J_TPU_TILED.with_(block_k=None)

# (B, K, N, L): fallback K tiles 64 (aligned), 128 (aligned, capped at
# the MXU dim), 512 (deep) and 256 (deep, capped by the overflow bound
# at L_I + L_W = 24)
MM = [(3, 40, 6, 4), (5, 200, 17, 8), (4, 600, 9, 8), (3, 600, 10, 12)]
# (kernel, stride, padding, C, OC, L): whole-K blocks of 27, 72, 64 and
# 144 (K = 64 is a power of two: the mma core's block on a card)
CONV = [(3, 1, "SAME", 3, 8, 8), (3, 2, "VALID", 8, 6, 4),
        (1, 1, "SAME", 64, 12, 8), (3, 1, "SAME", 16, 4, 8)]


def _mm(case):
    b, k, n, _ = case
    return normal((b, k), seed=k), normal((k, n), seed=n, scale=0.1)


def _conv(case):
    kk, _, _, c, oc, _ = case
    return (normal((2, 6, 7, c), seed=c + kk),
            normal((kk, kk, c, oc), seed=oc, scale=0.2))


@pytest.fixture(scope="module")
def refs():
    def ref_fn(mm_ops, conv_ops):
        mms = [jops.bfp_matmul(x, w, J_NONE.with_(l_i=c[3], l_w=c[3]),
                               interpret=True)
               for c, (x, w) in zip(MM, mm_ops)]
        convs = [ref.bfp_conv2d_ref(x, w, c[5], c[5], c[0] * c[0] * c[3],
                                    c[1], c[2])
                 for c, (x, w) in zip(CONV, conv_ops)]
        return mms, convs
    return to_numpy_tree(jax.jit(ref_fn)([_mm(c) for c in MM],
                                         [_conv(c) for c in CONV]))


def test_fallback_block_is_repros():
    assert tables.DEEP_K_BK == jtables.DEEP_K_BK
    for l_sum in range(4, 49):
        assert tables.overflow_cap(l_sum) == jtables.overflow_cap(l_sum)
    for k, block_k, l_sum in itertools.product(
            (1, 27, 200, 511, 512, 4608), (None, 32, 128),
            (8, 16, 24, 28, 32)):
        assert tables.fallback_block_k(k, block_k, l_sum) == \
            jtables.fallback_tiles(8, k, 128, block_k, l_sum)[2]


@pytest.mark.parametrize("i", range(len(MM)),
                         ids=[f"K{c[1]}-L{c[3]}" for c in MM])
def test_matmul_without_block_takes_the_fallback_tile(refs, i):
    x, w = _mm(MM[i])
    L = MM[i][3]
    got = ops.bfp_matmul(t(x), t(w), NONE.with_(l_i=L, l_w=L))
    assert_bits_equal(got, refs[0][i])


@pytest.mark.parametrize("i", range(len(CONV)),
                         ids=[f"K{c[0] * c[0] * c[3]}-L{c[5]}" for c in CONV])
def test_conv_without_block_is_whole_k(refs, i):
    kk, s, pad, _, _, L = CONV[i]
    x, w = _conv(CONV[i])
    got = ops.bfp_conv2d(t(x), t(w), NONE.with_(l_i=L, l_w=L), s, pad)
    assert_bits_equal(got, refs[1][i])


def test_whole_k_over_the_int32_guard_raises_in_both():
    # K = 576, L_I + L_W = 24: 24 + ceil(log2 576) = 34 > 32
    x, w = normal((1, 4, 4, 64), seed=1), normal((3, 3, 64, 2), seed=2)
    with pytest.raises(ValueError, match="overflows int32"):
        ops.bfp_conv2d(t(x), t(w), NONE.with_(l_i=12, l_w=12))
    with pytest.raises(ValueError, match="overflows int32"):
        jops.bfp_conv2d(x, w, J_NONE.with_(l_i=12, l_w=12), interpret=True)


def test_engine_still_refuses_block_k_none_on_the_kernel_backend():
    """As in repro, the kernel backend does not accept a policy without a
    block: the site warns and falls back to the emulated datapath."""
    x, w = t(normal((2, 8), seed=3)), t(normal((8, 4), seed=4))
    with pytest.warns(EG.BackendFallbackWarning, match="emulated"):
        got = EG.gemm(x, w, NONE.with_(backend="pallas"))
    assert torch.equal(got, EG.gemm(x, w, NONE.with_(backend="emulated")))
