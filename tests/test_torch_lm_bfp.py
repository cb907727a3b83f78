"""The port's LM on the BFP datapath against ``repro``: tinyllama and
minicpm (tied embeddings: ``lm_head`` a float-weight site), bound at
``PALLAS_TILED`` with block 32 on the port's kernel backend (the
kernels' plain versions on the CPU).

Every GEMM site of one forward and four decode steps is bit-equal: each
tapped (x, w) goes through ``repro.engine.gemm`` (its Pallas kernel in
interpret mode) and gives the port's output exactly.  The end-to-end
logits agree within ``torch_lm_common.BFP_LOGIT_TOL`` (2^-4 of the
largest |logit|, top-1 on 95% of the positions: see there why the float
ops between the sites need one).
"""
import pytest

from torch_lm_common import check_bfp_arch


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "minicpm-2b"])
def test_bfp_sites_bit_equal_and_logits(arch):
    plan = check_bfp_arch(arch)[0]
    tied = arch == "minicpm-2b"
    assert ("lm_head" in plan.sites) != tied
    assert all(s.prequantized for s in plan.sites.values())
