"""BFP training parity of RecurrentGemma (the hybrid) against ``repro``
at the reduced test size (d_model 64, d_ff 128, vocab 256; B = 2,
S = 32), under ``test_torch_lm_train.py``'s rules and with its helpers
(``torch_lm_common``), as ``test_torch_lm_train_recurrent.py`` does for
RWKV6 and seamless:

  * with straight-through at 5 layers (one (rec, rec, attn) period and
    a remainder of two rec blocks: every block kind of the 2- and
    3-layer layouts): loss, metrics and every gradient leaf by the BFP
    rule, on both backends, and the controls fail it;
  * without it at 2 layers (no period: the remainder alone) and 5: every
    tapped forward GEMM and its #dx and #dw bit-equal to the reference's
    integer datapath.  The whole gradient is not compared there: a probe
    of the reference on this init at 5 layers, with the params moved by
    one ulp in random directions, moved its own gradients by up to
    4.0e-2 of a leaf's largest (3.0e-2 in L2 norm), as much as the
    straight-through backward differs from the quantized one (5.5e-2).

All three layouts, with the empty ones' zero gradients, are checked
under the float policy in ``test_torch_lm_loop.py``.  The reference's
straight-through gradient at 5 layers takes about 20 s to compile: one
BFP whole-gradient case keeps this file within its time.
"""
import pytest

import torch_lm_common as LC

ARCH = "recurrentgemma-9b"


@pytest.mark.parametrize("backend", ["emulated", "pallas"])
def test_ste_loss_and_grads_match_repro(backend):
    LC.check_loss_and_grads(ARCH, 5, "ste", backend)


def test_bfp_rule_fails_the_wrong_backward():
    LC.check_bfp_rule_discriminates(ARCH, 5, "ste")


@pytest.mark.parametrize("backend", ["emulated", "pallas"])
@pytest.mark.parametrize("n_layers,n_sites", [(2, 17), (5, 40)])
def test_tapped_backward_gemms_bit_equal_repro(n_layers, n_sites, backend):
    LC.check_tapped(ARCH, n_layers, backend, n_sites=n_sites)
