"""``kernels.ops`` takes ``repro``'s arguments (ROADMAP F6).

* Every public function of the port's ``kernels.ops`` accepts the
  parameter names of ``repro``'s, in ``repro``'s positional order
  (``inspect.signature``).
* ``dot_impl`` raises where ``repro``'s raises (``resolve_dot_impl``,
  ported with ``f32_dot_exact`` and equal to ``repro``'s over a grid);
  every accepted mode, ``pipeline`` and ``interpret`` value gives the
  same bits, ``repro``'s (its Pallas matmul in interpret mode).
  ``repro``'s Pallas conv does not run on this jax (``ROADMAP.md`` R1),
  but it validates ``dot_impl`` before it builds, so its refusals are
  compared.
* The card's tile rules as pure functions: a (bm, bn) must be one of
  ``MMA_TILES`` and fit the core's shared memory at the block; a call on
  the tile kernel takes only that kernel's fixed tile; ``forced_tile``
  scopes the override outside ``mma_tile``'s cache.
"""
import inspect

import numpy as np
import pytest
import torch

from repro.core.policy import TPU_TILED as J_TILED
from repro.kernels import bfp_matmul as JKM
from repro.kernels import ops as jops
from repro_torch.core.policy import TPU_TILED
from repro_torch.kernels import _mma
from repro_torch.kernels import bfp_matmul as KM
from repro_torch.kernels import ops
from test_torch_util import assert_bits_equal, normal, t

PUBLIC = ("bfp_matmul", "bfp_matmul_prequant", "bfp_conv2d",
          "bfp_conv2d_prequant", "bfp_quantize")


@pytest.mark.parametrize("name", PUBLIC)
def test_signatures_accept_repros_keywords(name):
    want = inspect.signature(getattr(jops, name)).parameters
    got = inspect.signature(getattr(ops, name)).parameters
    assert list(want) == list(got)[:len(want)], (list(want), list(got))
    for p, wp in want.items():
        assert got[p].kind == wp.kind, p
        if wp.default is not inspect.Parameter.empty:
            assert got[p].default == wp.default, p
    assert set(jops.__all__) - {"default_tiles", "aligned_tile"} <= \
        set(ops.__all__)


def test_dot_rules_match_repro():
    for l_i in (2, 4, 8, 9, 12, 16):
        for l_w in (2, 6, 8, 10, 16):
            for bk in (1, 16, 32, 128, 512, 1024, 4096):
                assert KM.f32_dot_exact(l_i, l_w, bk) == \
                    JKM.f32_dot_exact(l_i, l_w, bk)
                for mode in ("auto", "int8", "int32", "f32", "bogus"):
                    for interp in (True, False):
                        for x_pq, w_pq in ((0, 0), (1, 0), (0, 1), (1, 1)):
                            kw = dict(l_i=l_i, l_w=l_w, bk=bk,
                                      interpret=interp, x_pq=bool(x_pq),
                                      w_pq=bool(w_pq))
                            try:
                                want = JKM.resolve_dot_impl(mode, **kw)
                            except ValueError:
                                with pytest.raises(ValueError):
                                    KM.resolve_dot_impl(mode, **kw)
                                continue
                            assert KM.resolve_dot_impl(mode, **kw) == want


X = normal((5, 64), seed=1)
W = normal((64, 12), seed=2, scale=0.1)
XC = normal((1, 6, 6, 8), seed=3)
WC = normal((3, 3, 8, 4), seed=4, scale=0.2)
MODES = [("auto", 8), ("int8", 8), ("int32", 8), ("f32", 8), ("int8", 12),
         ("f32", 12), ("bogus", 8)]


@pytest.mark.parametrize("mode,l", MODES, ids=[f"{m}-L{l}" for m, l in MODES])
def test_matmul_dot_impl_and_pipeline_match_repro(mode, l):
    pol, jpol = (TPU_TILED.with_(block_k=32, l_i=l, l_w=l),
                 J_TILED.with_(block_k=32, l_i=l, l_w=l))
    try:
        want = np.asarray(jops.bfp_matmul(X, W, jpol, True, dot_impl=mode,
                                          pipeline=False))
    except ValueError:
        for pipeline in (True, False):
            with pytest.raises(ValueError):
                ops.bfp_matmul(t(X), t(W), pol, dot_impl=mode,
                               pipeline=pipeline)
        return
    for interp in (None, True, False):
        for pipeline in (True, False):
            assert_bits_equal(ops.bfp_matmul(t(X), t(W), pol, interp,
                                             dot_impl=mode,
                                             pipeline=pipeline), want)


@pytest.mark.parametrize("mode,l", MODES, ids=[f"{m}-L{l}" for m, l in MODES])
def test_conv_dot_impl_refusals_match_repro(mode, l):
    pol, jpol = (TPU_TILED.with_(block_k=24, l_i=l, l_w=l),
                 J_TILED.with_(block_k=24, l_i=l, l_w=l))
    refuses = True
    try:
        JKM.resolve_dot_impl(mode, l_i=l, l_w=l, bk=24, interpret=True)
        refuses = False
    except ValueError:
        pass
    if refuses:
        with pytest.raises(ValueError):
            jops.bfp_conv2d(XC, WC, jpol, 1, "SAME", True, dot_impl=mode)
        with pytest.raises(ValueError):
            ops.bfp_conv2d(t(XC), t(WC), pol, 1, "SAME", True,
                           dot_impl=mode)
        return
    want = ops.bfp_conv2d(t(XC), t(WC), pol)
    for pipeline in (True, False):
        assert_bits_equal(ops.bfp_conv2d(t(XC), t(WC), pol, 1, "SAME",
                                         True, dot_impl=mode,
                                         pipeline=pipeline,
                                         tiles=(2, 8)), want)


def test_quantize_accepts_interpret():
    x = t(normal((7, 50), seed=5))
    want = ops.bfp_quantize(x, 8, 16)
    for interp in (None, True, False):
        got = ops.bfp_quantize(x, 8, 16, interp)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_card_tile_rules():
    for i, tile in enumerate(_mma.MMA_TILES):
        assert _mma.tile_index(tile, 128) == i
    with pytest.raises(ValueError, match="MMA_TILES"):
        _mma.tile_index((48, 64), 128)
    with pytest.raises(ValueError, match="shared memory"):
        _mma.tile_index((64, 128), 512)         # 64x128 stages bk <= 256
    assert _mma.tile_index((32, 64), 512) == 1
    assert ops._card_tile((32, 32), "mma", 128, None) == 2
    assert ops._card_tile((64, 64), "tile", 128, None) is None
    assert ops._card_tile((64, 128), "tile", 128, 8) is None
    for tile, out_bits in (((32, 64), None), ((64, 64), 8)):
        with pytest.raises(ValueError, match="MMA_TILES"):
            ops._card_tile(tile, "tile", 128, out_bits)
    # the override is scoped and never enters mma_tile's cache
    rule = _mma.mma_tile(6272, 512, 128)
    with _mma.forced_tile(3):
        assert _mma.pick_tile(6272, 512, 128) == 3
        with _mma.forced_tile(None):
            assert _mma.pick_tile(6272, 512, 128) == rule
    assert _mma.pick_tile(6272, 512, 128) == rule == \
        _mma.mma_tile(6272, 512, 128)


def test_cpu_takes_any_row_tile_and_checks_bk():
    pol = TPU_TILED.with_(block_k=32)
    want = ops.bfp_matmul(t(X), t(W), pol)
    for tiles in ((8, 8, 32), (48, 200, 32), (1, 1, 32)):
        assert_bits_equal(ops.bfp_matmul(t(X), t(W), pol, tiles=tiles),
                          want)
    with pytest.raises(ValueError, match="block"):
        ops.bfp_matmul(t(X), t(W), pol, tiles=(8, 8, 64))
    # a card conv tile's bk must be the conv's block
    with pytest.raises(ValueError, match="block"):
        ops._conv_tiles(XC.shape, WC.shape, 1, "SAME", pol, False,
                        (64, 64, 48), 24)
    assert ops._conv_tiles(XC.shape, WC.shape, 1, "SAME", pol, False,
                           (64, 64, 24), 24) == (64, 64)
