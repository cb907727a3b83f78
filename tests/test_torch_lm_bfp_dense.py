"""The port's LM on the BFP datapath against ``repro`` (see
``test_torch_lm_bfp.py``): mistral-nemo, qwen1.5 (QKV bias) and
qwen2-vl (M-RoPE, a dense FFN)."""
import pytest

from torch_lm_common import check_bfp_arch


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "qwen1.5-4b",
                                  "qwen2-vl-2b"])
def test_bfp_sites_bit_equal_and_logits(arch):
    plan = check_bfp_arch(arch)[0]
    assert len(plan.sites) == 8
