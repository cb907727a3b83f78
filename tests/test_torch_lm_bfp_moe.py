"""The port's LM on the BFP datapath against ``repro`` (see
``test_torch_lm_bfp.py``): mixtral and olmoe.  The
MoE expert GEMMs run the emulated datapath in both packages (not engine
sites): the port's batched expert GEMM is checked against the
reference's per-expert vmap bit for bit, on every route."""
import jax
import numpy as np
import pytest
import torch

from repro.core import policy as RPOL
from repro.core.prequant import prequant_leaf as r_prequant_leaf
from repro.models.lm import moe as RMOE
from repro_torch.core import policy as PPOL
from repro_torch.core.prequant import prequant_leaf as p_prequant_leaf
from repro_torch.models.lm import moe as PMOE
from test_torch_util import assert_bits_equal, normal, t
from torch_lm_common import check_bfp_arch


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "olmoe-1b-7b"])
def test_bfp_sites_bit_equal_and_logits(arch):
    plan, events = check_bfp_arch(arch)
    # experts bound (prequantized) but run per call on path "moe"; the
    # router stays float
    assert plan.sites["moe/w1"].prequantized
    assert plan.resolve("moe") is not None
    assert any(ev.policy is None for ev in events)


#: (label, scheme fields) of the expert-GEMM routes: TILED (the batched
#: computation), TILED whole-K (one block per column; a prequant sidecar
#: of one block takes the per-expert route), EQ4 and truncation
ROUTES = (("tiled32", dict(block_k=32)), ("tiled_wholeK", dict(block_k=None)),
          ("eq4", dict(scheme="EQ4", block_k=None)),
          ("tiled_trunc_L6", dict(block_k=16, rounding="TRUNCATE", l_w=6,
                                  l_i=6)))


def _pol(mod, kw):
    from importlib import import_module
    bfp = import_module(mod.__name__.replace(".policy", ".bfp"))
    kw = dict(kw)
    if "scheme" in kw:
        kw["scheme"] = getattr(bfp.Scheme, kw["scheme"])
    if "rounding" in kw:
        kw["rounding"] = getattr(bfp.Rounding, kw["rounding"])
    return mod.TPU_TILED.with_(straight_through=False, **kw)


@pytest.mark.parametrize("label,kw", ROUTES)
def test_expert_gemm_bit_equal(label, kw):
    """[E, C, K] x [E, K, N] with float and prequantized experts, one
    zero capacity row (an unused slot), against ``repro``'s vmapped
    per-expert datapath."""
    xe = normal((4, 5, 64), 11)
    xe[1, 3] = 0.0
    we = normal((4, 64, 24), 12, 0.1)
    rpol, ppol = _pol(RPOL, kw), _pol(PPOL, kw)
    pq_pol = rpol if rpol.block_k else rpol.with_(block_k=64)
    rq = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda w: r_prequant_leaf(w, pq_pol))(we))
    pq = p_prequant_leaf(t(we), ppol if ppol.block_k
                         else ppol.with_(block_k=64))
    assert_bits_equal(pq["m"], rq["m"])
    want_f, want_q = jax.jit(lambda x, w, q: (
        RMOE._expert_gemm(x, w, rpol), RMOE._expert_gemm(x, q, rpol)))(
        xe, we, rq)
    assert_bits_equal(PMOE._expert_gemm(t(xe), t(we), ppol),
                      np.asarray(want_f))
    assert_bits_equal(PMOE._expert_gemm(t(xe), pq, ppol),
                      np.asarray(want_q))
    # float policy: the einsum over dequantized experts
    got = PMOE._expert_gemm(t(xe), pq, None)
    want = np.einsum("ecd,edf->ecf", xe, rq["m"].astype(np.float32)
                     * np.repeat(rq["s"], 64 // rq["s"].shape[-2], axis=-2))
    assert np.allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert isinstance(got, torch.Tensor)
