"""The CUDA kernels against their plain versions, on a card.

Marked ``gpu``; without a card each test skips.  Imports neither JAX nor
the JAX package, so it runs on a machine that has only the port:

    python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import dataclasses

import pytest
import torch

from repro_torch.core.policy import PALLAS_TILED, TPU_TILED
from repro_torch.core.prequant import (prequant_act, prequant_conv_leaf,
                                       prequant_leaf)
from repro_torch import _tree
from repro_torch import engine as EG
from repro_torch.engine import PolicyMap
from repro_torch import kernels as K
from repro_torch.kernels import bfp_conv as KC
from repro_torch.kernels import bfp_matmul as KM
from repro_torch.kernels import bfp_quantize as KQ
from repro_torch.kernels import ops
from repro_torch.core.policy import BFPPolicy, PAPER_DEFAULT
from repro_torch.models.cnn import MODELS, vgg
from repro_torch.models.cnn import analysis as A
from repro_torch.serve.cnn import CnnServeEngine
from test_torch_util import (CONV_CASES, MM_CASES, Q_CASES, conv_inputs,
                             hazard_inputs, mm_inputs, normal, pq_k,
                             q_inputs, t)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions(cuda):
    """Each CUDA kernel against its plain version on the card: bit-equal
    (``torch.equal``), for L 4/8/12, ragged K, odd blocks, strides."""
    for case in MM_CASES:
        b, k, n, bk, L = case
        x, w = (t(a).to(cuda) for a in mm_inputs(case))
        got = KM.bfp_matmul(x, w, l_i=L, l_w=L, bk=bk)
        assert torch.equal(got, KM.bfp_matmul_plain(x, w, L, L, bk)), case
        kq = pq_k(k, bk)
        d = prequant_leaf(w[:kq], TPU_TILED.with_(block_k=bk))
        xq = x[:, :kq].contiguous()
        got = KM.bfp_matmul_prequant(xq, d["m"], d["s"], l_i=L, l_w=8, bk=bk)
        assert torch.equal(got, KM.bfp_matmul_prequant_plain(
            xq, d["m"], d["s"], L, 8, bk)), case
    for case in CONV_CASES:
        s, kk, pad, bk, L, c = case
        x, w = (t(a).to(cuda) for a in conv_inputs(case))
        got = KC.bfp_conv2d(x, w, l_i=L, l_w=L, bk=bk, stride=s, padding=pad)
        assert torch.equal(got, KC.bfp_conv2d_plain(x, w, L, L, bk, s,
                                                    pad)), case
        if (kk * kk * c) % bk == 0:
            d = prequant_conv_leaf(w, TPU_TILED.with_(block_k=bk))
            got = KC.bfp_conv2d_prequant(x, d["m"], d["s"], l_i=L, l_w=8,
                                         bk=bk, stride=s, padding=pad)
            assert torch.equal(got, KC.bfp_conv2d_prequant_plain(
                x, d["m"], d["s"], L, 8, bk, s, pad)), case
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_kernels_keep_the_reference_rounding(cuda):
    """The places a CUDA port drifts from the reference: FMA contraction
    of ``acc + part * (sx * sw)``, roundf instead of round-half-even,
    a reciprocal multiply for a subnormal step, a NaN or all-zero block,
    flush-to-zero of a subnormal amax, TF32.  Each row of
    ``hazard_inputs`` trips one of them; all must stay bit-equal."""
    x, w = (t(a).to(cuda) for a in hazard_inputs())
    got = KM.bfp_matmul(x, w, l_i=8, l_w=8, bk=32)
    want = KM.bfp_matmul_plain(x, w, 8, 8, 32)
    assert torch.equal(got, want)
    assert torch.isfinite(got).all() and bool((got[3] == 0).all())
    xc = x.reshape(1, 5, 8, 8)
    wc = w[:8].reshape(1, 1, 8, 6).contiguous()
    got = KC.bfp_conv2d(xc, wc, l_i=8, l_w=8, bk=8)
    assert torch.equal(got, KC.bfp_conv2d_plain(xc, wc, 8, 8, 8))


# (B, K, N, bk, out_block): out_block 128 spans two 64-column groups;
# ragged B, K a block multiple (the wire format needs bk | K)
WIRE_MM_CASES = [(5, 256, 384, 128, 128), (7, 96, 40, 32, 8),
                 (9, 192, 192, 64, 64), (3, 64, 48, 16, 16)]
# (stride, kernel, padding, bk, C, OC, out_block), bk | C
WIRE_CONV_CASES = [(1, 3, "SAME", 16, 32, 256, 128),
                   (2, 3, "SAME", 8, 16, 40, 8),
                   (1, 1, "VALID", 32, 64, 192, 64),
                   (2, 3, "VALID", 16, 16, 32, 32)]


def _hazard_rows(x):
    """Rows whose accumulators hold inf and NaN (huge activations) and
    zeros (an all-zero row), for the epilogue's block rules."""
    x = x.clone()
    x[1] = 3e38 * torch.sign(x[1])
    x[2] = 0.0
    return x


def _bits(a):
    """Bit patterns of a float tensor, every NaN as one canonical NaN
    (``torch.equal`` would call NaN != NaN; the hazard rows make some)."""
    if not a.is_floating_point():
        return a
    return torch.where(a.isnan(), torch.full_like(a, float("nan")),
                       a).view(torch.int32)


def _both_equal(got, want, what):
    if not isinstance(want, tuple):
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w)), what


@pytest.mark.gpu
def test_cuda_wire_kernels_and_epilogue_match_plain_versions(cuda):
    """The x-prequant and xw-prequant kernels, and the requantize
    epilogue on all eight entry points, against their plain versions on
    the card: bit-equal, including inf, NaN and zero accumulator blocks
    (and a wire x whose steps are inf / NaN)."""
    pol8 = TPU_TILED.with_(straight_through=False)
    for case in WIRE_MM_CASES:
        b, k, n, bk, ob = case
        pol = pol8.with_(block_k=bk)
        x = _hazard_rows(t(normal((b, k), seed=k)).to(cuda))
        w = t(normal((k, n), seed=n, scale=1e3)).to(cuda)
        d = prequant_leaf(w, pol)
        xq = prequant_act(t(normal((b, k), seed=b)).to(cuda), pol)
        xq["s"][1, 0] = float("inf")
        xq["s"][2, -1] = float("nan")
        xm, xs = xq["m"], xq["s"]
        for epi in ({}, {"out_bits": 8, "out_block": ob},
                    {"out_bits": 5, "out_block": ob}):
            calls = [
                (KM.bfp_matmul, KM.bfp_matmul_plain, (x, w)),
                (KM.bfp_matmul_prequant, KM.bfp_matmul_prequant_plain,
                 (x, d["m"], d["s"])),
                (KM.bfp_matmul_xprequant, KM.bfp_matmul_xprequant_plain,
                 (xm, xs, w)),
                (KM.bfp_matmul_xwprequant, KM.bfp_matmul_xwprequant_plain,
                 (xm, xs, d["m"], d["s"]))]
            for kern, plain, args in calls:
                got = kern(*args, l_i=8, l_w=8, bk=bk, **epi)
                want = plain(*args, 8, 8, bk, epi.get("out_bits"),
                             epi.get("out_block"))
                _both_equal(got, want, (kern.__name__, case, epi))
    for case in WIRE_CONV_CASES:
        s, kk, pad, bk, c, oc, ob = case
        pol = pol8.with_(block_k=bk)
        x = t(normal((2, 9, 10, c), seed=c + s)).to(cuda)
        x[1, 4] = 3e38 * torch.sign(x[1, 4])
        x[0, :, 2] = 0.0
        w = t(normal((kk, kk, c, oc), seed=oc, scale=1e3)).to(cuda)
        d = prequant_conv_leaf(w, pol)
        xq = prequant_act(t(normal((2, 9, 10, c), seed=oc + 1)).to(cuda), pol)
        xq["s"][0, 3, 3, 0] = float("inf")
        xq["s"][1, 5, 6, -1] = float("nan")
        xm, xs = xq["m"], xq["s"]
        for epi in ({}, {"out_bits": 8, "out_block": ob}):
            calls = [
                (KC.bfp_conv2d, KC.bfp_conv2d_plain, (x, w)),
                (KC.bfp_conv2d_prequant, KC.bfp_conv2d_prequant_plain,
                 (x, d["m"], d["s"])),
                (KC.bfp_conv2d_xprequant, KC.bfp_conv2d_xprequant_plain,
                 (xm, xs, w)),
                (KC.bfp_conv2d_xwprequant, KC.bfp_conv2d_xwprequant_plain,
                 (xm, xs, d["m"], d["s"]))]
            for kern, plain, args in calls:
                got = kern(*args, l_i=8, l_w=8, bk=bk, stride=s, padding=pad,
                           **epi)
                want = plain(*args, 8, 8, bk, s, pad, epi.get("out_bits"),
                             epi.get("out_block"))
                _both_equal(got, want, (kern.__name__, case, epi))
    torch.cuda.synchronize()


# (B, H, W, C, kernel, stride, padding, OC, bk, L): the int8 mma core at
# served shapes (ResNet-50 stage 4, VGG16 conv5, a stride-2 projection,
# GoogLeNet's 1x1 -> 24) and ragged ones (M or N not a tile multiple, bk
# 32 and 64, L 4), over all four tiles
MMA_CASES = [(8, 7, 7, 512, 3, 1, "SAME", 512, 128, 8),
             (8, 14, 14, 512, 3, 1, "SAME", 512, 128, 8),
             (8, 14, 14, 1024, 1, 2, "SAME", 2048, 128, 8),
             (8, 14, 14, 512, 1, 1, "SAME", 24, 128, 8),
             (3, 7, 5, 256, 3, 2, "VALID", 40, 64, 4),
             (2, 9, 6, 96, 3, 1, "SAME", 36, 32, 8),
             (8, 29, 29, 128, 3, 1, "SAME", 256, 128, 8),
             (8, 28, 28, 256, 1, 1, "SAME", 200, 128, 8)]


@pytest.mark.gpu
def test_cuda_mma_core_and_format_pass_match_plain_versions(cuda):
    """The activation format pass and the int8 mma conv core against
    their plain versions on the card, bit-equal: zero, NaN, inf and
    subnormal-amax pixel chunks, an inf weight step; the prequant conv
    launches one format pass and one core launch, the xw-prequant conv
    one core launch."""
    for case in MMA_CASES:
        b, h, wd, c, kk, s, pad, oc, bk, L = case
        assert KC.conv_core(False, True, bk, c, oc, L) == "mma", case
        x = t(normal((b, h, wd, c), seed=c + oc)).to(cuda)
        x[0, 0, 0, :bk] = 0.0
        x[0, 1, 1, 3] = float("nan")
        x[-1, 2, 2, bk - 1] = float("inf")
        x[0, h - 1, wd - 1, :bk] = 1e-40
        w = t(normal((kk, kk, c, oc), seed=oc, scale=0.05)).to(cuda)
        d = prequant_conv_leaf(w, TPU_TILED.with_(block_k=bk))
        d["s"][-1, 1] = float("inf")
        xm, xs = KC.bfp_conv2d_xformat(x, l_i=L, bk=bk)
        pm, ps = KC.bfp_conv2d_xformat_plain(x, L, bk)
        assert torch.equal(xm, pm) and torch.equal(_bits(xs), _bits(ps)), \
            case
        K.reset_launch_counts()
        got = KC.bfp_conv2d_prequant(x, d["m"], d["s"], l_i=L, l_w=8, bk=bk,
                                     stride=s, padding=pad)
        counts = K.launch_counts()
        assert counts["bfp_conv2d_xformat"] == 1 and \
            counts["bfp_conv2d_prequant"] == 1, (case, counts)
        want = KC.bfp_conv2d_prequant_plain(x, d["m"], d["s"], L, 8, bk, s,
                                            pad)
        _both_equal(got, want, ("prequant", case))
        got = KC.bfp_conv2d_xwprequant(xm, xs, d["m"], d["s"], l_i=L, l_w=8,
                                       bk=bk, stride=s, padding=pad)
        _both_equal(got, want, ("xwprequant", case))
    torch.cuda.synchronize()


# (B, H, W, C, kernel, stride, padding, OC, bk, L): the inline conv on
# the mma core at ragged shapes (M and OC not tile multiples, K-tiles
# spanning taps and wholly outside the image)
PATCH_CASES = [(3, 9, 7, 3, 7, 2, "SAME", 20, 32, 8),
               (2, 11, 5, 48, 3, 1, "VALID", 36, 128, 4)]


@pytest.mark.gpu
def test_cuda_patch_format_and_inline_conv_match_plain_versions(cuda):
    """The patch format pass and the inline conv it feeds to the mma core
    against their plain versions on the card, bit-equal: zero, NaN, inf
    and subnormal pixels, an inf weight; the inline conv launches one
    format pass and one core launch."""
    for case in PATCH_CASES:
        b, h, wd, c, kk, s, pad, oc, bk, L = case
        assert KC.conv_core(False, False, bk, c, oc, L, None, L) == "mma"
        x = t(normal((b, h, wd, c), seed=c + oc)).to(cuda)
        x[1] = 1e-40 * torch.sign(x[1])
        x[0, 0, 0, :] = 0.0
        x[0, 0, 1, 0] = float("nan")
        x[0, h - 1, wd - 1, c - 1] = float("inf")
        w = t(normal((kk, kk, c, oc), seed=oc, scale=0.05)).to(cuda)
        w[0, 0, 0, 1] = float("inf")
        got = KC.bfp_conv2d_pformat(x, w, l_i=L, l_w=L, bk=bk, stride=s,
                                    padding=pad)
        want = KC.bfp_conv2d_pformat_plain(x, w, L, L, bk, s, pad)
        for g, v in zip(got, want):
            assert torch.equal(_bits(g), _bits(v)), case
        K.reset_launch_counts()
        out = KC.bfp_conv2d(x, w, l_i=L, l_w=L, bk=bk, stride=s, padding=pad)
        counts = K.launch_counts()
        assert counts["bfp_conv2d_pformat"] == 1 and \
            counts["bfp_conv2d"] == 1, (case, counts)
        _both_equal(out, KC.bfp_conv2d_plain(x, w, L, L, bk, s, pad),
                    ("inline", case))
    torch.cuda.synchronize()


# (B, K, N, bk, L): the f32-output matmuls on the mma core at ragged
# shapes (B and N not tile multiples, K not a block multiple inline)
MM_MMA_CASES = [(17, 1536, 36, 512, 8), (3, 96, 20, 32, 4),
                (17, 2047, 44, 32, 8), (5, 300, 1000, 128, 4)]


@pytest.mark.gpu
def test_cuda_matmuls_on_the_mma_core_match_plain_versions(cuda):
    """The prequant matmul (format pass + core) and the inline matmul
    (patch format pass + core) as 1x1 convs on the mma core, against
    their plain versions on the card, bit-equal: zero, NaN, inf and
    subnormal rows, an inf weight and an inf weight step.  Each call
    launches one format pass and one core launch, counted under the
    matmul's names; no conv counter moves."""
    for case in MM_MMA_CASES:
        b, k, n, bk, L = case
        x = t(normal((b, k), seed=k + n)).to(cuda)
        x[0, :bk] = 0.0
        x[1, 3] = float("nan")
        x[2 % b, k - 1] = float("inf")
        x[-1] = 1e-40 * torch.sign(x[-1])
        w = t(normal((k, n), seed=n, scale=0.05)).to(cuda)
        if k % bk == 0:
            assert KM.matmul_core(True, bk, k, n, L, 8) == "mma", case
            d = prequant_leaf(w, TPU_TILED.with_(block_k=bk))
            d["s"][-1, 1] = float("inf")
            K.reset_launch_counts()
            got = KM.bfp_matmul_prequant(x, d["m"], d["s"], l_i=L, l_w=8,
                                         bk=bk)
            counts = {c: v for c, v in K.launch_counts().items() if v}
            assert counts == {"bfp_matmul_xformat": 1,
                              "bfp_matmul_prequant": 1}, (case, counts)
            _both_equal(got, KM.bfp_matmul_prequant_plain(
                x, d["m"], d["s"], L, 8, bk), ("prequant", case))
        assert KM.matmul_core(False, bk, k, n, L, L) == "mma", case
        w[k // 3, 1] = float("inf")
        K.reset_launch_counts()
        got = KM.bfp_matmul(x, w, l_i=L, l_w=L, bk=bk)
        counts = {c: v for c, v in K.launch_counts().items() if v}
        assert counts == {"bfp_matmul_pformat": 1, "bfp_matmul": 1}, \
            (case, counts)
        _both_equal(got, KM.bfp_matmul_plain(x, w, L, L, bk),
                    ("inline", case))
    torch.cuda.synchronize()


# (B, H, W, C, kernel, stride, padding, OC, bk, L, out_bits, out_block):
# the wire-x conv and the epilogue on the mma core at ragged M, OC not a
# multiple of 128, blocks 32/128/512, out_block 4..128, and at VGG16's
# conv5 shape at batch 8
EPI_CONV_CASES = [(2, 9, 7, 128, 3, 1, "SAME", 40, 32, 8, 8, 4),
                  (3, 7, 5, 256, 3, 2, "VALID", 200, 128, 4, 6, 8),
                  (2, 5, 6, 512, 1, 1, "SAME", 96, 512, 8, 3, 32),
                  (8, 14, 14, 512, 3, 1, "SAME", 512, 128, 8, 8, 128)]
# (B, K, N, bk, L, out_bits, out_block); prequant weights where bk | K
EPI_MM_CASES = [(17, 1536, 36, 512, 8, 8, 4), (5, 300, 1000, 128, 4, 6, 8),
                (8, 4096, 4096, 128, 8, 8, 128)]


def _counted(call):
    K.reset_launch_counts()
    out = call()
    return out, {c: v for c, v in K.launch_counts().items() if v}


@pytest.mark.gpu
def test_cuda_wire_x_conv_and_epilogue_on_the_mma_core(cuda):
    """The x-prequant conv (weight format pass + core) and the requantize
    epilogue of every conv mode and of the matmuls with f32 x (the
    output format pass after the core) against their plain versions on
    the card, bit-equal: zero, NaN, inf and subnormal pixels, wire steps
    that are inf, NaN and subnormal, an inf weight.  Each call launches
    the passes and the core its route predicts; L_W = 9, out_block = 2
    and OC % 4 != 0 keep the tile kernel."""
    for case in EPI_CONV_CASES:
        b, h, wd, c, kk, s, pad, oc, bk, L, ob_bits, ob = case
        x = t(normal((b, h, wd, c), seed=c + oc)).to(cuda)
        x[0, 0, 0, :bk] = 0.0
        x[0, 1, 1, 3] = float("nan")
        x[-1, 2, 2, bk - 1] = float("inf")
        x[0, h - 1, wd - 1, :bk] = 1e-40
        w = t(normal((kk, kk, c, oc), seed=oc, scale=0.05)).to(cuda)
        w[0, 0, 1, 2] = float("inf")
        xm, xs = KC.bfp_conv2d_xformat_plain(x, L, bk)
        xs[0, 2, 3, 0] = float("inf")
        xs[-1, 1, 1, -1] = float("nan")
        xs[1 % b, 3, 4, 0] = 1e-40
        d = prequant_conv_leaf(w, TPU_TILED.with_(block_k=bk))
        wm, ws = KC.bfp_conv2d_wformat(w, l_w=L, bk=bk)
        pm, ps = KC.bfp_conv2d_wformat_plain(w, L, bk)
        assert torch.equal(wm, pm) and torch.equal(_bits(ws), _bits(ps))
        geo = dict(stride=s, padding=pad)
        epi = dict(out_bits=ob_bits, out_block=ob)
        assert KC.conv_core(True, False, bk, c, oc, 8, ob_bits, L, ob) == \
            "mma", case
        for label, call, plain, want_counts in (
                ("xprequant", lambda: KC.bfp_conv2d_xprequant(
                    xm, xs, w, l_i=8, l_w=L, bk=bk, **geo),
                 lambda: KC.bfp_conv2d_xprequant_plain(
                    xm, xs, w, 8, L, bk, s, pad),
                 {"bfp_conv2d_xprequant": 1, "bfp_conv2d_wformat": 1}),
                ("xprequant+epi", lambda: KC.bfp_conv2d_xprequant(
                    xm, xs, w, l_i=8, l_w=L, bk=bk, **geo, **epi),
                 lambda: KC.bfp_conv2d_xprequant_plain(
                    xm, xs, w, 8, L, bk, s, pad, ob_bits, ob),
                 {"bfp_conv2d_xprequant": 1, "bfp_conv2d_wformat": 1,
                  "bfp_conv2d_oformat": 1, "bfp_conv2d_epilogue": 1}),
                ("xwprequant+epi", lambda: KC.bfp_conv2d_xwprequant(
                    xm, xs, d["m"], d["s"], l_i=8, l_w=8, bk=bk, **geo,
                    **epi),
                 lambda: KC.bfp_conv2d_xwprequant_plain(
                    xm, xs, d["m"], d["s"], 8, 8, bk, s, pad, ob_bits, ob),
                 {"bfp_conv2d_xwprequant": 1, "bfp_conv2d_oformat": 1,
                  "bfp_conv2d_epilogue": 1}),
                ("prequant+epi", lambda: KC.bfp_conv2d_prequant(
                    x, d["m"], d["s"], l_i=L, l_w=8, bk=bk, **geo, **epi),
                 lambda: KC.bfp_conv2d_prequant_plain(
                    x, d["m"], d["s"], L, 8, bk, s, pad, ob_bits, ob),
                 {"bfp_conv2d_prequant": 1, "bfp_conv2d_xformat": 1,
                  "bfp_conv2d_oformat": 1, "bfp_conv2d_epilogue": 1}),
                ("inline+epi", lambda: KC.bfp_conv2d(
                    x, w, l_i=L, l_w=L, bk=bk, **geo, **epi),
                 lambda: KC.bfp_conv2d_plain(x, w, L, L, bk, s, pad,
                                             ob_bits, ob),
                 {"bfp_conv2d": 1, "bfp_conv2d_pformat": 1,
                  "bfp_conv2d_oformat": 1, "bfp_conv2d_epilogue": 1}),
                # the tile kernel's cases: L_W = 9, out_block = 2
                ("xprequant L9", lambda: KC.bfp_conv2d_xprequant(
                    xm, xs, w, l_i=8, l_w=9, bk=bk, **geo, **epi),
                 lambda: KC.bfp_conv2d_xprequant_plain(
                    xm, xs, w, 8, 9, bk, s, pad, ob_bits, ob),
                 {"bfp_conv2d_xprequant": 1, "bfp_conv2d_epilogue": 1}),
                ("xwprequant ob2", lambda: KC.bfp_conv2d_xwprequant(
                    xm, xs, d["m"], d["s"], l_i=8, l_w=8, bk=bk, **geo,
                    out_bits=ob_bits, out_block=2),
                 lambda: KC.bfp_conv2d_xwprequant_plain(
                    xm, xs, d["m"], d["s"], 8, 8, bk, s, pad, ob_bits, 2),
                 {"bfp_conv2d_xwprequant": 1, "bfp_conv2d_epilogue": 1})):
            got, counts = _counted(call)
            assert counts == want_counts, (label, case, counts)
            _both_equal(got, plain(), (label, case))
        # OC % 4 != 0: the tile kernel
        w30 = w[..., :30].contiguous()
        got, counts = _counted(lambda: KC.bfp_conv2d_xprequant(
            xm, xs, w30, l_i=8, l_w=L, bk=bk, **geo, out_bits=ob_bits,
            out_block=2))
        assert counts == {"bfp_conv2d_xprequant": 1,
                          "bfp_conv2d_epilogue": 1}, (case, counts)
        _both_equal(got, KC.bfp_conv2d_xprequant_plain(
            xm, xs, w30, 8, L, bk, s, pad, ob_bits, 2), ("OC 30", case))
    for case in EPI_MM_CASES:
        b, k, n, bk, L, ob_bits, ob = case
        x = t(normal((b, k), seed=k + n)).to(cuda)
        x[0, :bk] = 0.0
        x[1, 3] = float("nan")
        x[2, k - 1] = float("inf")
        x[-1] = 1e-40 * torch.sign(x[-1])
        w = t(normal((k, n), seed=n, scale=0.05)).to(cuda)
        w[k // 3, 1] = float("inf")
        epi = dict(out_bits=ob_bits, out_block=ob)
        if k % bk == 0:
            d = prequant_leaf(w, TPU_TILED.with_(block_k=bk))
            got, counts = _counted(lambda: KM.bfp_matmul_prequant(
                x, d["m"], d["s"], l_i=L, l_w=8, bk=bk, **epi))
            assert counts == {"bfp_matmul_prequant": 1,
                              "bfp_matmul_xformat": 1,
                              "bfp_matmul_oformat": 1,
                              "bfp_matmul_epilogue": 1}, (case, counts)
            _both_equal(got, KM.bfp_matmul_prequant_plain(
                x, d["m"], d["s"], L, 8, bk, ob_bits, ob),
                ("prequant+epi", case))
        got, counts = _counted(lambda: KM.bfp_matmul(
            x, w, l_i=L, l_w=L, bk=bk, **epi))
        assert counts == {"bfp_matmul": 1, "bfp_matmul_pformat": 1,
                          "bfp_matmul_oformat": 1,
                          "bfp_matmul_epilogue": 1}, (case, counts)
        _both_equal(got, KM.bfp_matmul_plain(x, w, L, L, bk, ob_bits, ob),
                    ("inline+epi", case))
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_chain_on_the_wire_equals_the_float_chain(cuda):
    """Through the engine on the card: each producer's fused epilogue
    equals ``prequant_act`` of its f32 output, and the wire chain's end
    equals the float-activation chain (quantization idempotence)."""
    pol = PALLAS_TILED.with_(straight_through=False)
    x = t(normal((2, 14, 14, 256), seed=5)).to(cuda)
    w1 = t(normal((3, 3, 256, 256), seed=6, scale=0.03)).to(cuda)
    w2 = t(normal((3, 3, 256, 128), seed=7, scale=0.03)).to(cuda)
    for prequant in (False, True):
        a, b = ((prequant_conv_leaf(w1, pol), prequant_conv_leaf(w2, pol))
                if prequant else (w1, w2))
        K.reset_launch_counts()
        y = EG.conv2d(x, a, pol, out_policy=pol)
        z = EG.conv2d(y, b, pol)
        counts = K.launch_counts()
        assert counts["bfp_conv2d_epilogue"] == 1
        assert counts["bfp_conv2d_xwprequant" if prequant
                      else "bfp_conv2d_xprequant"] == 1
        two = prequant_act(EG.conv2d(x, a, pol), pol)
        assert torch.equal(y["m"], two["m"]) and torch.equal(y["s"], two["s"])
        assert torch.equal(z, EG.conv2d(EG.conv2d(x, a, pol), b, pol))


@pytest.mark.gpu
@pytest.mark.parametrize("bk", [128, 8])
def test_served_vgg16_on_the_card_equals_the_cpu(cuda, bk):
    """Reduced VGG16 served on the card (CUDA kernels) is bit-equal to the
    same model served on the CPU (plain versions): every step of both is
    an IEEE-rounded f32 operation or an exact integer dot."""
    params = MODELS["vgg16"].init(torch.Generator().manual_seed(1),
                                  device="cpu")
    pol = PALLAS_TILED.with_(block_k=bk, straight_through=False)
    images = t(normal((3, 32, 32, 3), seed=4))
    logits = {}
    for dev in ("cpu", cuda):
        plan = EG.bind(params, pol, tree="cnn", strict=True, device=dev)
        eng = CnnServeEngine(None, vgg.apply, plan, slots=2, device=dev)
        K.reset_launch_counts()
        reqs = [eng.submit(image=images[i]) for i in range(3)]
        eng.run()
        assert eng.stats["completed"] == 3 and eng.stats["failed"] == 0
        logits[str(dev)] = torch.stack([torch.from_numpy(r.logits)
                                        for r in reqs])
    # one launch of a conv or matmul core per layer; an inline conv or
    # matmul on the mma core (block 128: the 13 convs, fc6 and fc7; fc8's
    # N = 10 stays on the tile kernel) adds one patch format pass
    counts = K.launch_counts()
    passes = counts["bfp_conv2d_pformat"] + counts["bfp_matmul_pformat"]
    assert sum(counts.values()) - passes == 16 * eng.ncalls
    assert counts["bfp_conv2d_pformat"] == (13 * eng.ncalls if bk == 128
                                            else 0)
    assert counts["bfp_matmul_pformat"] == (2 * eng.ncalls if bk == 128
                                            else 0)
    assert torch.equal(logits["cpu"], logits["cuda"])


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["bfp_packed", "bfp_packed_v2"])
def test_packed_artifact_served_on_the_card(cuda, tmp_path, fmt):
    """A packed reduced-VGG16 artifact cold-started as a tenant on the
    card: its containers unpack into sidecars on the card, the prequant
    kernels serve them, and the logits equal the float tree bound on the
    card and the same artifact served on the CPU."""
    from repro_torch.checkpoint import store
    from repro_torch.serve.tenants import MultiTenantServer
    params = MODELS["vgg16"].init(torch.Generator().manual_seed(2),
                                  device="cpu")
    pol = PALLAS_TILED.with_(block_k=8, straight_through=False)
    store.save(str(tmp_path), 0, params, format=fmt, policy=pol)
    images = t(normal((3, 32, 32, 3), seed=6))
    logits = {}
    for dev in ("cpu", cuda):
        srv = MultiTenantServer(device=dev)
        ten = srv.add_tenant("v", "vgg16", checkpoint_dir=str(tmp_path),
                             policy=pol, strict_backend=True, slots=4)
        assert ten.plan.params["conv2_1"]["w"]["m"].device.type == \
            torch.device(dev).type
        K.reset_launch_counts()
        reqs = [srv.submit("v", image=images[i]) for i in range(3)]
        srv.run()
        counts = K.launch_counts()
        assert all(r.error is None for r in reqs)
        logits[str(dev)] = torch.stack([torch.from_numpy(r.logits)
                                        for r in reqs])
    assert counts["bfp_conv2d_prequant"] == 12 and counts["bfp_conv2d"] == 1
    plan = EG.bind(params, pol, tree="cnn", strict=True, device=cuda)
    want = plan.jit_forward(vgg.apply)(images.to(cuda)).cpu()
    assert torch.equal(logits["cuda"], want)
    assert torch.equal(logits["cpu"], logits["cuda"])


@pytest.mark.gpu
def test_cuda_bfp_quantize_matches_plain_version(cuda):
    """The block-formatting kernel on ragged M and K, bk 8..512, bits
    4..12 (int8 saturation above 8), zero/inf/NaN blocks and half-way
    mantissas: ``torch.equal`` to its plain version on the card and on
    the CPU, through the kernel wrapper (ragged edge in the kernel) and
    through ``ops`` (unpadded, one launch a call)."""
    before = K.launch_counts()["bfp_quantize"]
    for case in Q_CASES:
        _, _, bk, bits = case
        x = t(q_inputs(case))
        want = KQ.bfp_quantize_plain(x, bits, bk)
        for got in (KQ.bfp_quantize(x.to(cuda), bits=bits, bk=bk),
                    ops.bfp_quantize(x.to(cuda), bits, bk)):
            for g, w in zip(got, want):
                assert torch.equal(g.cpu(), w), case
        plain_card = KQ.bfp_quantize_plain(x.to(cuda), bits, bk)
        for g, w in zip(plain_card, want):
            assert torch.equal(g.cpu(), w), case
    torch.cuda.synchronize()
    assert K.launch_counts()["bfp_quantize"] == before + 2 * len(Q_CASES)


# ((M, K, bk, bits), path): the vector path (K % 16 == 0, bk % 16 == 0,
# bk <= 512, 16-byte aligned) at blocks 16, 32, 48 (a 4-lane group of 3),
# 128 and 512, ragged last tiles, a 64 x 64 weight and M = 1000; the
# scalar path at ragged K and at blocks 8 and 1024
Q_PATH_CASES = [((1000, 4608, 32, 8), "vector"), ((64, 64, 128, 8), "vector"),
                ((37, 2304, 512, 4), "vector"), ((40, 480, 48, 12), "vector"),
                ((9, 144, 16, 6), "vector"), ((1000, 2047, 128, 8), "scalar"),
                ((6, 96, 8, 8), "scalar"), ((7, 2048, 1024, 9), "scalar")]


@pytest.mark.gpu
def test_cuda_bfp_quantize_vector_and_scalar_paths(cuda):
    """Each path of the block-formatting kernel against the plain version
    on the card, bit-equal (zero, NaN, inf, -inf and half-way blocks):
    the path is the one the launch reports for the shape, one launch per
    call; an x that starts 4 bytes off 16-byte alignment (a contiguous
    view at an offset) takes the scalar path and stays equal."""
    for case, path in Q_PATH_CASES:
        m, k, bk, bits = case
        x = t(q_inputs(case))
        xc = x.to(cuda)
        probe = torch.empty((m, k), dtype=torch.int8, device=cuda)
        assert KQ.kernel_path(xc, probe, bk) == path, case
        got, counts = _counted(lambda: KQ.bfp_quantize(xc, bits=bits,
                                                       bk=bk))
        assert counts == {"bfp_quantize": 1}, (case, counts)
        for g, w in zip(got, KQ.bfp_quantize_plain(x, bits, bk)):
            assert torch.equal(g.cpu(), w), case
    m, k, bk, bits = 300, 1024, 128, 8
    x = t(q_inputs((m, k, bk, bits)))
    flat = torch.zeros(m * k + 1, device=cuda)
    xo = flat[1:].view(m, k)
    xo.copy_(x.to(cuda))
    probe = torch.empty((m, k), dtype=torch.int8, device=cuda)
    assert xo.is_contiguous() and xo.data_ptr() % 16 == 4
    assert KQ.kernel_path(xo, probe, bk) == "scalar"
    assert KQ.kernel_path(xo.clone(), probe, bk) == "vector"
    for g, w in zip(ops.bfp_quantize(xo, bits, bk),
                    KQ.bfp_quantize_plain(x, bits, bk)):
        assert torch.equal(g.cpu(), w)
    torch.cuda.synchronize()


# (B, K, N, bk, L_W, out_bits, out_block) of the wire-x matmul on the
# mma core: chain B's fc7 and fc8 at batch 8, M = 1 and 17, blocks 32,
# 128 and 512, out_block 4 and 128
WX_MM_CASES = [(8, 4096, 4096, 128, 8, 8, 128),
               (8, 4096, 1000, 128, 8, None, None),
               (1, 4096, 1000, 512, 4, 6, 8), (17, 1536, 36, 32, 8, 3, 4),
               (17, 2048, 256, 512, 6, 8, 128)]


@pytest.mark.gpu
def test_cuda_wire_x_matmul_on_the_mma_core(cuda):
    """The x-prequant matmul (wire x, float w) on the mma core against its
    plain version on the card, bit-equal, with an all-zero x block, wire
    steps that are inf, NaN and subnormal and an inf weight: each call
    launches the weight format pass and the core (and with ``out_bits``
    the output format pass) from one host call; L_W = 9, N = 30 and
    out_block = 2 keep the tile kernel."""
    for case in WX_MM_CASES:
        b, k, n, bk, lw, ob_bits, ob = case
        x = t(normal((b, k), seed=k + n, scale=2.0)).to(cuda)
        x[0, :bk] = 0.0
        xq = prequant_act(x, TPU_TILED.with_(block_k=bk,
                                             straight_through=False))
        xm, xs = xq["m"], xq["s"]
        xs[0, -1] = float("inf")
        xs[-1, 0] = float("nan")
        if b > 2:
            xs[1, 0] = 1e-40
        w = t(normal((k, n), seed=n, scale=0.02)).to(cuda)
        w[k // 3, 1] = float("inf")
        epi = dict(out_bits=ob_bits, out_block=ob)
        assert KM.matmul_core(False, bk, k, n, 8, lw, ob_bits, ob,
                              wire_x=True) == "mma", case
        want_counts = {"bfp_matmul_xprequant": 1, "bfp_matmul_wformat": 1}
        if ob_bits is not None:
            want_counts.update(bfp_matmul_oformat=1, bfp_matmul_epilogue=1)
        got, counts = _counted(lambda: KM.bfp_matmul_xprequant(
            xm, xs, w, l_i=8, l_w=lw, bk=bk, **epi))
        assert counts == want_counts, (case, counts)
        _both_equal(got, KM.bfp_matmul_xprequant_plain(
            xm, xs, w, 8, lw, bk, ob_bits, ob), case)
        # the tile kernel's cases
        tile_cases = (("L9", 9, w, ob), ("N30", lw, w[:, :30].contiguous(),
                                         None), ("ob2", lw, w, 2))
        for label, lw2, w2, ob2 in tile_cases:
            bits2 = None if ob2 is None else (ob_bits or 8)
            assert KM.matmul_core(False, bk, k, w2.shape[1], 8, lw2, bits2,
                                  ob2, wire_x=True) == "tile", label
            got, counts = _counted(lambda: KM.bfp_matmul_xprequant(
                xm, xs, w2, l_i=8, l_w=lw2, bk=bk, out_bits=bits2,
                out_block=ob2))
            assert counts == ({"bfp_matmul_xprequant": 1} if bits2 is None
                              else {"bfp_matmul_xprequant": 1,
                                    "bfp_matmul_epilogue": 1}), \
                (label, case, counts)
            _both_equal(got, KM.bfp_matmul_xprequant_plain(
                xm, xs, w2, 8, lw2, bk, bits2, ob2), (label, case))
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_emulated_datapath_equals_the_cpu(cuda):
    """The emulated backend (float64 products of integer mantissas) on
    the card: LeNet under the paper's policy, bit-equal to the CPU."""
    params = MODELS["lenet"].init(torch.Generator().manual_seed(0),
                                  device="cpu")
    x = t(normal((4, 28, 28, 1), seed=3))
    want = MODELS["lenet"].apply(
        EG.bind(params, PAPER_DEFAULT, device="cpu").params, x,
        PAPER_DEFAULT)
    plan = EG.bind(params, PAPER_DEFAULT, device=cuda)
    got = plan.jit_forward(MODELS["lenet"].apply)(x.to(cuda))
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_cuda_xw_matmul_on_the_mma_core(cuda):
    """The xw-prequant matmul (both operands on the wire) on the mma core
    against its plain version on the card, bit-equal, with an all-zero x
    block, x steps that are inf, NaN and subnormal and an inf weight
    step: each call launches the core alone (and with ``out_bits`` the
    output format pass) from one host call; a block of 96, N = 30 and
    out_block = 2 keep the tile kernel."""
    for case in WX_MM_CASES:
        b, k, n, bk, lw, ob_bits, ob = case
        pol = TPU_TILED.with_(block_k=bk, l_w=lw, straight_through=False)
        x = t(normal((b, k), seed=k + n, scale=2.0)).to(cuda)
        x[0, :bk] = 0.0
        xq = prequant_act(x, pol)
        xm, xs = xq["m"], xq["s"]
        xs[0, -1] = float("inf")
        xs[-1, 0] = float("nan")
        if b > 2:
            xs[1, 0] = 1e-40
        d = prequant_leaf(t(normal((k, n), seed=n, scale=0.02)).to(cuda),
                          pol)
        d["s"][k // bk - 1, 1] = float("inf")
        assert KM.matmul_core(True, bk, k, n, 8, lw, ob_bits, ob,
                              wire_x=True) == "mma", case
        want_counts = {"bfp_matmul_xwprequant": 1}
        if ob_bits is not None:
            want_counts.update(bfp_matmul_oformat=1, bfp_matmul_epilogue=1)
        got, counts = _counted(lambda: KM.bfp_matmul_xwprequant(
            xm, xs, d["m"], d["s"], l_i=8, l_w=lw, bk=bk, out_bits=ob_bits,
            out_block=ob))
        assert counts == want_counts, (case, counts)
        _both_equal(got, KM.bfp_matmul_xwprequant_plain(
            xm, xs, d["m"], d["s"], 8, lw, bk, ob_bits, ob), case)
    # the tile kernel's cases: block 96, N = 30, out_block 2
    x = t(normal((17, 1536), seed=5, scale=2.0)).to(cuda)
    w = t(normal((1536, 36), seed=6, scale=0.03)).to(cuda)
    for label, bk, n, ob_bits, ob in (("bk96", 96, 36, 8, 4),
                                      ("N30", 32, 30, None, None),
                                      ("ob2", 32, 36, 8, 2)):
        pol = TPU_TILED.with_(block_k=bk, straight_through=False)
        xq = prequant_act(x, pol)
        d = prequant_leaf(w[:, :n].contiguous(), pol)
        assert KM.matmul_core(True, bk, 1536, n, 8, 8, ob_bits, ob,
                              wire_x=True) == "tile", label
        got, counts = _counted(lambda: KM.bfp_matmul_xwprequant(
            xq["m"], xq["s"], d["m"], d["s"], l_i=8, l_w=8, bk=bk,
            out_bits=ob_bits, out_block=ob))
        assert counts == ({"bfp_matmul_xwprequant": 1} if ob_bits is None
                          else {"bfp_matmul_xwprequant": 1,
                                "bfp_matmul_epilogue": 1}), (label, counts)
        _both_equal(got, KM.bfp_matmul_xwprequant_plain(
            xq["m"], xq["s"], d["m"], d["s"], 8, 8, bk, ob_bits, ob), label)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_table4_analysis_equals_the_cpu(cuda):
    """``analyze_vgg`` on a reduced VGG16 under the paper's policy (the
    emulated datapath) on the card against the CPU: the same rows within
    1e-3 dB (the float run's GEMMs sum in another order on each; a
    non-finite value must be the same value)."""
    params = vgg.init(torch.Generator().manual_seed(0), 10, width_mult=0.25,
                      input_hw=32, fc_dim=64, device="cpu")
    x = t(normal((2, 32, 32, 3), seed=0))
    want = A.analyze_vgg(params, x, BFPPolicy())
    gpu_params = {k: {n: v.to(cuda) for n, v in p.items()}
                  for k, p in params.items()}
    K.reset_launch_counts()
    got = A.analyze_vgg(gpu_params, x.to(cuda), BFPPolicy())
    assert not any(K.launch_counts().values())
    assert [r.name for r in got] == [r.name for r in want] == \
        vgg.conv_names()
    for g, w in zip(got, want):
        for f in ("input_ex", "input_single", "input_multi", "weight_ex",
                  "weight_model", "output_ex", "output_single",
                  "output_multi", "relu_ex"):
            a, b = getattr(g, f), getattr(w, f)
            assert a == b or abs(a - b) < 1e-3, (g.name, f, a, b)


#: (x shape, w shape, the backward GEMM held, its fitted block, its core)
#: one backward GEMM per route: the mma core (conv1_2-like #dw over
#: M = 512 at block 128), the tile kernel at a block that is no power of
#: two (a 7x7 stage's #dw over M = 392: block 98) and at N' = 27 (conv1_1's
#: #dx: kh*kw*C)
BACKWARD_ROUTES = (((2, 16, 16, 64), (3, 3, 64, 64), "conv_dw", 128, "mma"),
                   ((8, 7, 7, 32), (3, 3, 32, 32), "conv_dw", 98, "tile"),
                   ((2, 8, 8, 3), (3, 3, 3, 64), "conv_dx", 64, "tile"))


@pytest.mark.gpu
@pytest.mark.parametrize("route", range(3), ids=["mma", "tile-bk98",
                                                 "tile-n27"])
def test_cuda_backward_gemms_match_plain_versions(cuda, route):
    """A conv's backward on the kernel backend: each backward GEMM (its
    operands captured by a tap) equal to the plain version on the same
    card tensors, on the predicted core, and the whole backward
    deterministic (run twice, ``torch.equal``)."""
    xs, ws, kind, bk, core = BACKWARD_ROUTES[route]
    pol = PALLAS_TILED.with_(straight_through=False)
    x = t(normal(xs, seed=route)).to(cuda).relu()
    w = t(normal(ws, seed=route + 1, scale=0.1)).to(cuda)
    g = t(normal((*xs[:3], ws[3]), seed=route + 2)).to(cuda)

    def backward():
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        events = []
        with EG.taps(events.append):
            (EG.conv2d(xr, wr, pol, path="c") * g).sum().backward()
        return xr.grad, wr.grad, {e.kind: e for e in events}

    K.reset_launch_counts()
    dx, dw, ev = backward()
    counts = K.launch_counts()
    e = ev[kind]
    k, n = e.x.shape[1], e.w.shape[1]
    assert e.policy.block_k == bk and e.backend == "pallas"
    assert KM.matmul_core(False, bk, k, n, 8, 8) == core
    assert torch.equal(e.y, KM.bfp_matmul_plain(e.x, e.w, 8, 8, bk))
    other = ev["conv_dx" if kind == "conv_dw" else "conv_dw"]
    pb = other.policy.block_k
    assert torch.equal(other.y, KM.bfp_matmul_plain(other.x, other.w, 8, 8,
                                                    pb))
    assert counts["bfp_conv2d"] == 1 and counts["bfp_matmul"] == 2
    dx2, dw2, _ = backward()
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
    assert torch.isfinite(dx).all() and torch.isfinite(dw).all()
    torch.cuda.synchronize()


def _lenet_train_policy(**kw):
    return PolicyMap.of(
        ("^c1$", PALLAS_TILED.with_(block_k=25, straight_through=False,
                                    **kw)),
        default=PALLAS_TILED.with_(block_k=16, straight_through=False, **kw))


def _register_plain_backend():
    """Backend "plain": the kernels' plain versions, for dense float
    operands (all a training step gives the engine) and prequantized
    matmul weights (a served LM's)."""
    def matmul(x, w, p, out_policy=None):
        if isinstance(w, dict):
            kb = w["m"].shape[0] // w["s"].shape[0]
            return KM.bfp_matmul_prequant_plain(x, w["m"], w["s"], p.l_i,
                                                p.l_w, kb)
        return KM.bfp_matmul_plain(x, w, p.l_i, p.l_w, p.block_k)

    EG.register_backend(
        "plain", matmul,
        conv=lambda x, w, p, stride, padding, out_policy=None:
        KC.bfp_conv2d_plain(x, w, p.l_i, p.l_w, p.block_k, stride,
                            padding))


def _far_share(got, want):
    """Share of elements off by more than 1e-5 relative + 1e-5 of the
    largest magnitude (the CPU parity rule of test_torch_train_cnn.py)."""
    d = (got - want).abs()
    return float((d > 1e-5 * want.abs() + 1e-5 * float(
        want.abs().max())).float().mean())


@pytest.mark.gpu
def test_cuda_train_step_matches_the_cpu(cuda):
    """One LeNet step on the kernels: ``torch.equal`` to the same step on
    the kernels' plain versions on the card, and deterministic.  Against
    the same step on the CPU, where float reductions (the log-softmax,
    col2im, the bias sums) order differently, by the CPU parity rule of
    ``test_torch_train_cnn.py``: the loss within 1e-5 relative, the
    grad norm within 1e-4 relative; the per-worker gradients and the
    parameters within 1e-5 relative + 1e-5 of the leaf's largest
    magnitude for all but 1% of elements (a last bit can move a quantized
    block's rounding), and every parameter within AdamW's ``2.5 * lr``."""
    from repro_torch import _tree
    from repro_torch.train import cnn as TC
    _register_plain_backend()
    cfg = TC.CnnTrainConfig(model="lenet", workers=2, batch=16, lr=1e-3,
                            grad_bits=8, policy=_lenet_train_policy())
    pcfg = TC.CnnTrainConfig(model="lenet", workers=2, batch=16, lr=1e-3,
                             grad_bits=8,
                             policy=_lenet_train_policy(backend="plain"))
    s_cpu = TC.init_state(cfg, device="cpu")
    x, y, _ = TC.data_batch(cfg, 0, device="cpu")
    s_gpu = _tree.tree_map(lambda a: a.to(cuda), s_cpu)
    xg, yg = x.to(cuda), y.to(cuda)
    step = TC.make_cnn_train_step(cfg)
    a, ma = step(s_cpu, (x, y))
    K.reset_launch_counts()
    b, mb = step(s_gpu, (xg, yg))
    assert K.launch_counts()["bfp_matmul"] > 0
    c, _ = step(s_gpu, (xg, yg))
    K.reset_launch_counts()
    p, mp = TC.make_cnn_train_step(pcfg)(s_gpu, (xg, yg))
    assert not any(K.launch_counts().values())
    lb, lc, lp = (_tree.flatten(s)[0] for s in (b, c, p))
    assert len(lb) == len(lc) == len(lp)
    assert all(torch.equal(u, v) for u, v in zip(lb, lc))
    assert all(torch.equal(u, v) for u, v in zip(lb, lp))
    assert torch.equal(mb["loss"], mp["loss"])
    assert abs(float(ma["loss"]) - float(mb["loss"])) <= 1e-5 * abs(
        float(ma["loss"]))
    assert abs(float(ma["grad_norm"]) - float(mb["grad_norm"])) <= (
        1e-4 * float(ma["grad_norm"]))
    apply = MODELS["lenet"].apply
    _, g_cpu = TC._worker_grads(cfg, apply, s_cpu.params, x, y)
    _, g_gpu = TC._worker_grads(cfg, apply, s_gpu.params, xg, yg)
    for u, v in zip(_tree.flatten(g_gpu)[0], _tree.flatten(g_cpu)[0]):
        assert _far_share(u.cpu(), v) <= 0.01
    for u, v in zip(_tree.flatten(b.params)[0], _tree.flatten(a.params)[0]):
        assert _far_share(u.cpu(), v) <= 0.01
        assert float((u.cpu() - v).abs().max()) <= 2.5 * cfg.lr


@pytest.mark.gpu
def test_cuda_every_mma_tile_gives_the_same_bits(cuda):
    """A tuned or explicit tile (``tiles=``) forces one of ``MMA_TILES`` on
    the mma core's launches: every tile that fits the block gives the
    rule's bits, the plain version's; one that does not fit, one that is
    not a core tile, and any but the tile kernel's own on a call routed
    there raise."""
    from repro_torch.kernels import _mma

    g = torch.Generator().manual_seed(7)
    x = torch.randn((100, 1024), generator=g).to(cuda)
    w = (0.1 * torch.randn((1024, 64), generator=g)).to(cuda)
    xc = torch.randn((2, 14, 14, 512), generator=g).to(cuda)
    wc = (0.05 * torch.randn((3, 3, 512, 96), generator=g)).to(cuda)
    for bk in (128, 512):
        pol = TPU_TILED.with_(block_k=bk)
        wq = prequant_leaf(w, pol)
        wcq = prequant_conv_leaf(wc, pol)
        calls = {
            "matmul": lambda **kw: ops.bfp_matmul(x, w, pol, **kw),
            "matmul_prequant": lambda **kw: ops.bfp_matmul_prequant(
                x, wq["m"], wq["s"], pol, **kw),
            "conv": lambda **kw: ops.bfp_conv2d(xc, wc, pol, **kw),
            "conv_prequant": lambda **kw: ops.bfp_conv2d_prequant(
                xc, wcq["m"], wcq["s"], pol, **kw)}
        plain = {"matmul": KM.bfp_matmul_plain(x, w, 8, 8, bk),
                 "conv": KC.bfp_conv2d_plain(xc, wc, 8, 8, bk)}
        for name, call in calls.items():
            want = call()
            assert torch.equal(want, plain[name.split("_")[0]]), name
            for tile in _mma.MMA_TILES:
                bk_t = (bk,) if name.startswith("matmul") else ()
                if _mma._mma_smem(*tile, bk) > _mma._SMEM:
                    with pytest.raises(ValueError, match="shared memory"):
                        call(tiles=(*tile, *bk_t))
                    continue
                K.reset_launch_counts()
                got = call(tiles=(*tile, *bk_t))
                assert torch.equal(got, want), (name, bk, tile)
                assert sum(K.launch_counts().values()) >= 1
            with pytest.raises(ValueError, match="MMA_TILES"):
                call(tiles=(48, 64, bk))
    # L = 9 routes the inline conv to the tile kernel: only its tile
    pol9 = TPU_TILED.with_(block_k=128, l_i=9, l_w=9)
    want = ops.bfp_conv2d(xc, wc, pol9)
    assert torch.equal(ops.bfp_conv2d(xc, wc, pol9, tiles=(64, 64)), want)
    with pytest.raises(ValueError, match="MMA_TILES"):
        ops.bfp_conv2d(xc, wc, pol9, tiles=(32, 64))


@pytest.mark.gpu
def test_cuda_bound_plan_with_a_tuned_cache_hits_on_every_site(cuda):
    """``tune_plan`` on the card stores entries under the card's target;
    a plan bound with the cache hits on every site of every served
    forward (no miss) and serves the untuned plan's logits."""
    from repro_torch.tune import CARD_TARGET, TuneCache
    from repro_torch.tune.autotune import tune_plan

    params = MODELS["vgg16"].init(torch.Generator().manual_seed(1),
                                  device="cpu")
    pol = PALLAS_TILED.with_(straight_through=False)
    images = t(normal((8, 32, 32, 3), seed=4)).to(cuda)
    plan = EG.bind(params, pol, tree="cnn", strict=True, device=cuda)
    cache = TuneCache()
    ents = tune_plan(plan, vgg.apply, images, cache=cache, max_steps=4,
                     iters=2)
    # sites of one shape share one entry (one key)
    assert len(ents) == 16 and 1 <= len(cache) <= 16
    assert all(k.endswith(":" + CARD_TARGET) for k in cache.entries)
    assert all({"bm", "bn", "bk", "us", "steps"} <= set(e)
               for e in ents.values())
    tuned = EG.bind(params, pol, tree="cnn", strict=True, device=cuda,
                    tune_cache=cache)
    cache.hits = cache.misses = 0
    logits = {}
    for name, p in (("untuned", plan), ("tuned", tuned)):
        eng = CnnServeEngine(None, vgg.apply, p, slots=8, device=cuda)
        reqs = [eng.submit(image=images[i]) for i in range(8)]
        eng.run()
        logits[name] = torch.stack([torch.from_numpy(r.logits)
                                    for r in reqs])
    assert (cache.hits, cache.misses) == (16 * eng.ncalls, 0)
    assert torch.equal(logits["tuned"], logits["untuned"])


@pytest.mark.gpu
@pytest.mark.parametrize("arch,per_step", [("tinyllama-1.1b", 2 * 7 + 1),
                                           ("olmoe-1b-7b", 2 * 4 + 1)])
def test_cuda_lm_decode_and_serving_match_plain_versions(cuda, arch,
                                                         per_step):
    """A reduced LM (2 layers, d_model 64) bound at ``PALLAS_TILED``
    (block 32, prequantized) on the kernels: four decode steps'
    logits and caches ``torch.equal`` to the same steps through the
    plain versions, one prequant matmul and one activation format pass
    per linear per step, and served tokens equal to the plain-version
    engine's and to solo serving."""
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models.lm import model as LM
    from repro_torch.serve.engine import Request, ServeEngine

    _register_plain_backend()
    cfg = reduced(ARCHS[arch], n_layers=2, d_model=64, d_ff=128, vocab=256)
    cfg = dataclasses.replace(cfg, capacity_factor=float(max(
        cfg.n_experts, 1)))
    params = LM.init_params(cfg, torch.Generator().manual_seed(0),
                            device=cuda)
    pol = PALLAS_TILED.with_(block_k=32, straight_through=False)
    toks = torch.randint(0, 256, (4, 4), generator=torch.Generator()
                         .manual_seed(1)).to(cuda)
    runs = {}
    for name in ("kernels", "plain"):
        plan = EG.bind(params, pol.with_(backend="pallas" if name ==
                                         "kernels" else "plain"),
                       tree="lm", strict=True, device=cuda)
        cache = LM.init_cache(cfg, 4, 16, device=cuda)
        K.reset_launch_counts()
        logits = []
        with torch.inference_mode():
            for i in range(4):
                lg, cache = LM.decode_step(plan.params, cfg, cache,
                                           toks[:, i:i + 1], i, plan)
                logits.append(lg)
        torch.cuda.synchronize()
        runs[name] = (torch.stack(logits), cache, K.launch_counts())
    (lk, ck, nk), (lp, cp, npl) = runs["kernels"], runs["plain"]
    assert torch.equal(lk, lp)
    assert all(torch.equal(ck[k], cp[k]) for k in ("k", "v"))
    assert nk["bfp_matmul_prequant"] == nk["bfp_matmul_xformat"] == \
        4 * per_step
    assert sum(npl.values()) == 0
    outs = {}
    prompts = [[1, 2, 3], [9, 8, 7, 6, 5], [4, 4]]
    for name, be in (("kernels", "pallas"), ("plain", "plain")):
        p = pol.with_(backend=be)
        eng = ServeEngine(params, cfg, slots=4, max_len=32, policy=p,
                          prequant=p, strict_backend=True, device=cuda)
        rs = [Request(rid=i, prompt=pr, max_new=5)
              for i, pr in enumerate(prompts)]
        for r in rs:
            eng.submit(r)
        eng.run()
        assert all(r.error is None for r in rs)
        outs[name] = [r.out for r in rs]
    assert outs["kernels"] == outs["plain"]
    solo = ServeEngine(params, cfg, slots=4, max_len=32, policy=pol,
                       prequant=pol, device=cuda)
    r = Request(rid=9, prompt=prompts[1], max_new=5)
    solo.submit(r)
    solo.run()
    assert r.out == outs["kernels"][1]



@pytest.mark.gpu
@pytest.mark.parametrize("arch,layers,per_step,fwd", [
    # RWKV6's decode drops the policy (only lm_head on the kernels); its
    # forward runs 10 linears a layer and lm_head
    ("rwkv6-3b", 2, {"bfp_matmul_prequant": 1}, 2 * 10 + 1),
    # 4 rec blocks (8 linears), 1 attention block (7), the tied head on
    # the float embed.T (bfp_matmul after a patch pass)
    ("recurrentgemma-9b", 5, {"bfp_matmul_prequant": 39, "bfp_matmul": 1},
     40),
    # 11 linears a decoder layer and lm_head
    ("seamless-m4t-medium", 2, {"bfp_matmul_prequant": 23}, 7 + 23)])
def test_cuda_recurrent_and_encdec_lms_match_plain_versions(cuda, arch,
                                                            layers,
                                                            per_step, fwd):
    """A reduced recurrent LM or encoder-decoder (d_model 64) bound at
    ``PALLAS_TILED`` (block 32, prequantized) on the kernels: a forward
    and four decode steps ``torch.equal`` to the plain versions (logits
    and every cache leaf), the kernel launches a step as counted from the
    code, and served (or generated) tokens equal to the plain-version
    ones and to solo serving (the encoder-decoder: its rows rolled)."""
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models.lm import model as LM
    from repro_torch.serve.engine import Request, ServeEngine, generate

    _register_plain_backend()
    cfg = reduced(ARCHS[arch], n_layers=layers, d_model=64, d_ff=128,
                  vocab=256)
    params = LM.init_params(cfg, torch.Generator().manual_seed(0),
                            device=cuda)
    pol = PALLAS_TILED.with_(block_k=32, straight_through=False)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, 256, (4, 8), generator=g).to(cuda)
    enc = (torch.randn((4, cfg.enc_seq_stub, cfg.d_model), generator=g)
           .to(cuda) if cfg.is_encdec else None)
    runs = {}
    for name in ("kernels", "plain"):
        plan = EG.bind(params, pol.with_(backend="pallas" if name ==
                                         "kernels" else "plain"),
                       tree="lm", strict=True, device=cuda)
        with torch.inference_mode():
            K.reset_launch_counts()
            flog = LM.forward(plan.params, cfg, toks, enc_feats=enc,
                              policy=plan)[0]
            nf = K.launch_counts()
            cache = LM.init_cache(cfg, 4, 16, device=cuda)
            if enc is not None:
                cache["enc_out"] = LM.prefill_encoder(plan.params, cfg, enc,
                                                      plan)
            K.reset_launch_counts()
            logits = []
            for i in range(4):
                lg, cache = LM.decode_step(plan.params, cfg, cache,
                                           toks[:, i:i + 1], i, plan)
                logits.append(lg)
        torch.cuda.synchronize()
        runs[name] = (flog, torch.stack(logits), cache, nf,
                      K.launch_counts())
    (fk, lk, ck, nfk, nk), (fp, lp, cp, _, npl) = (runs["kernels"],
                                                   runs["plain"])
    assert torch.equal(fk, fp) and torch.equal(lk, lp)
    assert all(torch.equal(a, b) for a, b in zip(_tree.flatten(ck)[0],
                                                  _tree.flatten(cp)[0]))
    assert sum(npl.values()) == 0
    assert {k: v for k, v in nk.items() if v and not k.endswith(
        "format")} == {k: 4 * v for k, v in per_step.items()}
    assert sum(v for k, v in nfk.items() if not k.endswith("format")) == fwd
    prompts = [[1, 2, 3], [9, 8, 7, 6, 5], [4, 4]]
    outs = {}
    for name, be in (("kernels", "pallas"), ("plain", "plain")):
        p = pol.with_(backend=be)
        if cfg.is_encdec:
            outs[name] = generate(params, cfg, toks[:, :4], 5, policy=p,
                                  enc_feats=enc, max_len=16,
                                  device=cuda).tolist()
            continue
        eng = ServeEngine(params, cfg, slots=4, max_len=32, policy=p,
                          prequant=p, strict_backend=True, device=cuda)
        rs = [Request(rid=i, prompt=pr, max_new=5)
              for i, pr in enumerate(prompts)]
        for r in rs:
            eng.submit(r)
        eng.run()
        assert all(r.error is None for r in rs)
        outs[name] = [r.out for r in rs]
    assert outs["kernels"] == outs["plain"]
    if cfg.is_encdec:
        # rows rolled by one slot (the batch geometry kept: at another
        # batch size cuBLAS may sum the float attention in another order)
        perm = torch.roll(torch.arange(4, device=cuda), 1)
        rolled = generate(params, cfg, toks[perm, :4], 5, policy=pol,
                          enc_feats=enc[perm], max_len=16, device=cuda)
        assert rolled.tolist() == [outs["kernels"][i] for i in
                                   perm.tolist()]
        return
    solo = ServeEngine(params, cfg, slots=4, max_len=32, policy=pol,
                       prequant=pol, device=cuda)
    r = Request(rid=9, prompt=prompts[1], max_new=5)
    solo.submit(r)
    solo.run()
    assert r.out == outs["kernels"][1]


@pytest.mark.gpu
@pytest.mark.parametrize("arch,straight_through,per_step", [
    # 7 linears of 2 layers and lm_head, forward and both backward GEMMs
    ("tinyllama-1.1b", False, 3 * 15),
    # 4 attention linears of 2 layers and lm_head, forward only: the
    # straight-through backward is float, the experts emulated (F9)
    ("olmoe-1b-7b", True, 9)])
def test_cuda_lm_train_step_matches_plain_versions(cuda, arch,
                                                   straight_through,
                                                   per_step):
    """A reduced LM's ``make_train_step`` step at ``PALLAS_TILED``
    (block 32) on the kernels: ``torch.equal`` to the same step through
    the plain versions (params, AdamW moments, step, metrics) and to
    itself repeated, with ``bfp_matmul`` launches as counted from the
    code; the experts' gradients non-zero."""
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import ARCHS
    from repro_torch.data.pipeline import LMBatchSpec, lm_batch
    from repro_torch.train import step as TS

    _register_plain_backend()
    cfg = reduced(ARCHS[arch], n_layers=2, d_model=64, d_ff=128, vocab=256)
    state = TS.init_state(cfg, torch.Generator().manual_seed(0),
                          device=cuda)
    batch = lm_batch(LMBatchSpec(vocab_size=256, seq_len=32,
                                 global_batch=2), 0, device=cuda)
    pol = PALLAS_TILED.with_(block_k=32, straight_through=straight_through)
    runs = []
    for be in ("pallas", "pallas", "plain"):
        step = TS.make_train_step(cfg, policy=pol.with_(backend=be))
        K.reset_launch_counts()
        new, metrics = step(state, batch)
        torch.cuda.synchronize()
        runs.append((new, metrics, K.launch_counts()))
    (a, ma, na), (b, mb, _), (p, mp, npl) = runs
    for other, mo in ((b, mb), (p, mp)):
        assert all(torch.equal(u, v) for u, v in zip(_tree.flatten(a)[0],
                                                     _tree.flatten(other)[0]))
        assert all(torch.equal(ma[k], mo[k]) for k in ma)
    assert sum(npl.values()) == 0
    assert {k: v for k, v in na.items() if v and not k.endswith(
        "format")} == {"bfp_matmul": per_step}
    if cfg.is_moe:
        mu = a.opt_state.mu["layers"]["moe"]
        assert all(float(mu[k].abs().sum()) > 0 for k in ("w1", "w2", "w3"))
