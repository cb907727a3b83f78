"""The CUDA kernels against their plain versions, on a card.

Marked ``gpu``; without a card each test skips.  Imports neither JAX nor
the JAX package, so it runs on a machine that has only the port:

    python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import pytest
import torch

from repro_torch.core.policy import PALLAS_TILED, TPU_TILED
from repro_torch.core.prequant import prequant_conv_leaf, prequant_leaf
from repro_torch import engine as EG
from repro_torch import kernels as K
from repro_torch.kernels import bfp_conv as KC
from repro_torch.kernels import bfp_matmul as KM
from repro_torch.models.cnn import MODELS, vgg
from repro_torch.serve.cnn import CnnServeEngine
from test_torch_util import (CONV_CASES, MM_CASES, conv_inputs,
                             hazard_inputs, mm_inputs, normal, pq_k, t)


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
    assert sum(K.launch_counts().values()) == 16 * eng.ncalls
    assert torch.equal(logits["cpu"], logits["cuda"])
