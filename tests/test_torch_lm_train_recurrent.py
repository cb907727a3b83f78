"""BFP training parity of RWKV6 (ssm) and seamless (encoder-decoder)
against ``repro`` at the reduced test size (2 layers, d_model 64, d_ff
128, vocab 256; B = 2, S = 32: RWKV6's chunked WKV needs S % 32 == 0),
under ``test_torch_lm_train.py``'s rules and with its helpers
(``torch_lm_common``); RecurrentGemma's are in
``test_torch_lm_train_hybrid.py``.

  * With straight-through (``TILED`` block 32, the port on the emulated
    backend and on its kernel backend): loss and metrics within 1e-5
    relative, every gradient leaf by the BFP rule (all but 1% of
    elements within 1e-5 relative + 1e-5 of the leaf's largest), and
    the controls (the quantized backward, the float policy) fail it.
  * Without it: every forward GEMM the port taps and its #dx and #dw
    are bit-equal to the reference's integer datapath on the tapped
    operands.  The whole gradient is not compared there: in these
    models it moves with a single flipped block rounding, and last-place
    noise moves the reference's own.  A probe of the reference on this
    init, with the params moved by one ulp in random directions, moved
    RWKV6's gradients by up to 5.2e-2 of a leaf's largest (2.3e-2 in L2
    norm) and seamless' by up to 2.5e-2 (1.8e-2), as much as the
    straight-through backward differs from the quantized one (4.5e-2,
    4.3e-2), so no rule on the whole gradient tells a precision fault
    from a flip; the GEMMs, tapped, can be held exactly.
"""
import pytest

import torch_lm_common as LC

ARCHS = [("rwkv6-3b", 2), ("seamless-m4t-medium", 2)]


@pytest.mark.parametrize("backend", ["emulated", "pallas"])
@pytest.mark.parametrize("arch,n_layers", ARCHS)
def test_ste_loss_and_grads_match_repro(arch, n_layers, backend):
    LC.check_loss_and_grads(arch, n_layers, "ste", backend)


@pytest.mark.parametrize("arch,n_layers", ARCHS)
def test_bfp_rule_fails_the_wrong_backward(arch, n_layers):
    LC.check_bfp_rule_discriminates(arch, n_layers, "ste")


@pytest.mark.parametrize("backend", ["emulated", "pallas"])
@pytest.mark.parametrize("arch,n_layers,n_sites",
                         [("rwkv6-3b", 2, 21), ("seamless-m4t-medium", 2, 30)])
def test_tapped_backward_gemms_bit_equal_repro(arch, n_layers, n_sites,
                                               backend):
    LC.check_tapped(arch, n_layers, backend, n_sites=n_sites)
