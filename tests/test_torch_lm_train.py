"""The port's LM training step (``repro_torch.train.step``) against
``repro.train.step``: ``lm_loss`` and its gradients for TinyLlama and
OLMoE at the reduced test size (2 layers, d_model 64, d_ff 128, vocab
256; B = 2, S = 32), whole ``make_train_step`` steps, the MoE experts'
straight-through gradient (F9) and the gradient at clamp ties (F10).
The recurrent families and the encoder-decoder are in
``test_torch_lm_loop.py`` (float policy), ``test_torch_lm_train_recurrent
.py`` (straight-through) and ``test_torch_lm_train_taps.py`` (the
quantized backward, GEMM by GEMM): the reference's BFP gradients take
7-20 s each to trace and compile, and each file stays within its time.

Both packages start from the port's seeded init exported as numpy
(``torch_lm_common.train_params_np``; the stacked layout is the same in
both) and take the same numpy tokens.  The reference side is one
``jax.jit`` per case (``torch_lm_common.ref_train_case``: its
value_and_grad, and for TinyLlama its train steps in the same jit).

Tolerances (``g`` the port's, ``r`` the reference's):

  * loss and metrics within 1e-5 relative (1e-7 absolute: the aux loss
    of a dense model is 0);
  * float policy: each gradient leaf within 1e-5 of its largest |r|
    (the float ops — RMSNorm, softmax, logsumexp, the WKV's cumsum / exp
    / einsums — reduce in another order in XLA and PyTorch);
  * BFP (``TILED``, block 32, straight-through on and off; the port on
    the emulated backend and on its kernel backend, whose plain versions
    run on the CPU): PR 25's rule, all but 1% of each leaf's elements
    within 1e-5 relative + 1e-5 of the leaf's largest |r| (a block
    rounding may flip on a last-place difference in a float op upstream;
    none does in these cases: the largest difference is about 6e-7 of a
    leaf's largest).  Each BFP case has controls that must fail the
    rule: the port's gradient under the other backward (straight-through
    against the quantized one) and under the float policy
    (``torch_lm_common.check_bfp_rule_discriminates``), so a gradient of
    the wrong precision cannot pass.  Every forward and backward GEMM of
    TinyLlama's quantized backward, tapped, is also bit-equal to the
    reference's on the tapped operands (``test_torch_lm_loop.py``).

A whole step: metrics as above, ``step`` exactly, AdamW's ``mu`` /
``nu`` by the gradient rule of the case (a compressed step's by the BFP
rule: the 8-bit wire rounds like a BFP site), and params by
``tests/test_torch_train_cnn.py``'s rule: every element within 2.5 lr
(AdamW's first update is about lr sign(g), so an element whose tiny
gradient changes sign moves by up to 2 lr) and all but 1% within 1e-5
relative + 1e-5 of the leaf's largest.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm_common as LC
from repro.models.lm import griffin as RG
from repro.models.lm import model as RM
from repro.models.lm import rwkv6 as RW
from repro_torch import _tree
from repro_torch.core.policy import TPU_TILED
from repro_torch.dist.compress import make_compressor
from repro_torch.models.lm import griffin as PG
from repro_torch.models.lm import rwkv6 as PW
from repro_torch.models.lm.common import scalar
from repro_torch.optim import optimizers as opt
from repro_torch.train import step as PS
from test_torch_util import assert_bits_equal, normal, t

#: (arch, layers, kind): kind "float" (policy None), "ste" (TILED block
#: 32, straight-through) or "hard" (the same without: backward GEMMs
#: quantized under the grad-path policies)
CASES = [("tinyllama-1.1b", 2, "float"), ("tinyllama-1.1b", 2, "hard"),
         ("olmoe-1b-7b", 2, "float"), ("olmoe-1b-7b", 2, "ste")]


#: each case once per port backend a BFP policy can name (the float
#: policy names none)
RUNS = [(a, n, k, be) for a, n, k in CASES
        for be in (("emulated",) if k == "float" else ("emulated", "pallas"))]


@pytest.mark.parametrize("arch,n_layers,kind,backend", RUNS)
def test_loss_and_grads_match_repro(arch, n_layers, kind, backend):
    LC.check_loss_and_grads(arch, n_layers, kind, backend)


@pytest.mark.parametrize("arch,n_layers,kind",
                         [c for c in CASES if c[2] != "float"])
def test_bfp_rule_fails_the_wrong_backward(arch, n_layers, kind):
    LC.check_bfp_rule_discriminates(arch, n_layers, kind)


# ---------------------------------------------------------------------------
# whole steps
# ---------------------------------------------------------------------------

def check_step(new, metrics, ref, bfp_moments: bool):
    rstate, rmetrics = ref
    assert sorted(metrics) == sorted(rmetrics)
    for k in metrics:
        LC.assert_scalar(metrics[k], rmetrics[k])
    assert int(new.step) == int(rstate.step)
    assert int(new.opt_state.step) == int(rstate.opt_state.step)
    lr = float(metrics["lr"])
    moment = LC.assert_bfp_leaf if bfp_moments else LC.assert_float_leaf
    for tree, rtree, check in (
            (new.params, rstate.params, lambda g, w:
             LC.assert_param_leaf(g, w, lr)),
            (new.opt_state.mu, rstate.opt_state.mu, moment),
            (new.opt_state.nu, rstate.opt_state.nu, moment)):
        got, want = LC.np_leaves(tree), LC.ref_leaves(rtree)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            check(g, w)


@pytest.mark.parametrize("name", ["step", "accum2", "compress"])
def test_float_step_matches_repro(name):
    """One ``make_train_step`` step under the float policy from a state
    at step 3 (cosine schedule past its warmup): plain, with
    ``grad_accum=2`` (no nll / aux / zloss in its metrics, as in
    ``repro``) and through ``make_compressor(bits=8)`` from a zero
    residual."""
    pcfg = LC.cfgs("tinyllama-1.1b")[1]
    kw = {"step": {}, "accum2": {"grad_accum": 2}}.get(name)
    if kw is None:
        init_fn, transform = make_compressor(bits=8)
        kw = {"grad_transform": lambda g: transform(g, init_fn(g))[0]}
    step = PS.make_train_step(pcfg, opt.cosine_schedule(*LC.SCHED), **kw)
    p = LC.port_train_params("tinyllama-1.1b")
    new, metrics = step(LC.port_train_state(p, LC.STEP0),
                        (t(LC.TOKENS), t(LC.TARGETS)))
    assert (name == "accum2") == ("nll" not in metrics)
    ref = LC.ref_train_case("tinyllama-1.1b", 2, "float")[name]
    check_step(new, metrics, ref, bfp_moments=name == "compress")


@pytest.mark.parametrize("backend", ["emulated", "pallas"])
def test_bfp_step_matches_repro(backend):
    """One step without straight-through at the default (constant)
    schedule from step 0: ``lr`` a CPU 0-d tensor of ``repro``'s value."""
    pcfg = LC.cfgs("tinyllama-1.1b")[1]
    step = PS.make_train_step(pcfg, policy=LC.port_policy("hard", backend))
    p = LC.port_train_params("tinyllama-1.1b")
    new, metrics = step(LC.port_train_state(p, 0),
                        (t(LC.TOKENS), t(LC.TARGETS)))
    assert float(metrics["lr"]) == float(np.float32(3e-4))
    ref = LC.ref_train_case("tinyllama-1.1b", 2, "hard")["step"]
    check_step(new, metrics, ref, bfp_moments=True)


def test_grad_accumulation_equivalence():
    """``grad_accum=2`` over the batch == one full-batch step (same loss
    and params within 2e-3), the counterpart of ``tests/test_system.py``'s
    check."""
    pcfg = LC.cfgs("tinyllama-1.1b")[1]
    p = LC.port_train_params("tinyllama-1.1b")
    batch = (t(LC.TOKENS), t(LC.TARGETS))
    s1, m1 = PS.make_train_step(pcfg)(LC.port_train_state(p, 0), batch)
    s2, m2 = PS.make_train_step(pcfg, grad_accum=2)(
        LC.port_train_state(p, 0), batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 2e-3
    assert max(float((a - b).abs().max()) for a, b in zip(
        _tree.flatten(s1.params)[0], _tree.flatten(s2.params)[0])) < 2e-3


def test_init_state_layout():
    """``init_state``: seeded params, zero AdamW moments, step 0 (int32,
    0-d), the same for the same seed."""
    pcfg = LC.cfgs("olmoe-1b-7b")[1]
    a = PS.init_state(pcfg, torch.Generator().manual_seed(1), device="cpu")
    b = PS.init_state(pcfg, torch.Generator().manual_seed(1), device="cpu")
    assert a.step.dtype == torch.int32 and a.step.shape == ()
    for u, v in zip(_tree.flatten(a)[0], _tree.flatten(b)[0]):
        assert torch.equal(u, v)
    assert all(float(m.abs().max()) == 0.0
               for m in _tree.flatten(a.opt_state.mu)[0])
    want = jax.eval_shape(lambda k: RM.init_params(LC.cfgs("olmoe-1b-7b")[0],
                                                   k), jax.random.PRNGKey(0))
    assert [tuple(x.shape) for x in _tree.flatten(a.params)[0]] == [
        tuple(x.shape) for x in jax.tree_util.tree_leaves(want)]


# ---------------------------------------------------------------------------
# F9: the MoE experts' straight-through gradient
# ---------------------------------------------------------------------------

def _expert_leaves(grads):
    moe = grads["layers"]["moe"]
    return [moe[k] for k in ("w1", "w2", "w3")]


def _ref_expert_leaves(rgrads):
    moe = rgrads["layers"]["moe"]
    return [np.asarray(moe[k]) for k in ("w1", "w2", "w3")]


@pytest.mark.parametrize("backend", ["emulated", "pallas"])
def test_moe_expert_grads_straight_through(backend):
    """With straight-through the expert GEMMs (the batched TILED
    datapath) return the estimator's gradients: present, non-zero and
    the reference's (its vmapped ``bfp_matmul_2d`` custom VJP)."""
    (_, _), grads = LC.port_value_and_grad("olmoe-1b-7b", 2,
                                    LC.port_policy("ste", backend))
    want = _ref_expert_leaves(
        LC.ref_train_case("olmoe-1b-7b", 2, "ste")["vg"][1])
    for g, w in zip(_expert_leaves(grads), want):
        assert float(g.abs().sum()) > 0 and np.abs(w).sum() > 0
        LC.assert_bfp_leaf(g, w)


def test_moe_expert_grads_zero_without_straight_through():
    """Without it the reference differentiates through its quantizer and
    the expert weights get zeros (a probe of ``jax.grad`` on this model:
    sum |dL/dw1| = 0.0): the port gives zeros too, not None, and the
    layers around the experts keep their gradients."""
    (_, _), grads = LC.port_value_and_grad(
        "olmoe-1b-7b", 2, LC.port_policy("hard", "emulated"))
    for g in _expert_leaves(grads):
        assert isinstance(g, torch.Tensor) and g.shape[0] == 2
        assert float(g.abs().sum()) == 0.0
    moe = grads["layers"]["moe"]
    assert float(moe["router"]["w"].abs().sum()) > 0
    assert float(grads["layers"]["attn"]["wq"]["w"].abs().sum()) > 0


def test_moe_expert_ste_forward_unchanged():
    """The estimator's forward is ``_batched_tiled`` bit for bit, and
    its backward the per-expert ``bfp_matmul_2d`` estimator's."""
    from repro_torch.core.bfp_dot import bfp_matmul_2d
    from repro_torch.models.lm.moe import _batched_tiled, _expert_gemm

    pol = TPU_TILED.with_(block_k=LC.BLOCK)
    xe = t(normal((4, 6, 64), seed=1)).requires_grad_()
    we = t(normal((4, 64, 32), seed=2, scale=0.1)).requires_grad_()
    y = _expert_gemm(xe, we, pol)
    assert torch.equal(y, _batched_tiled(xe.detach(), we.detach(), pol))
    g = t(normal((4, 6, 32), seed=3))
    gx, gw = torch.autograd.grad(y, (xe, we), g)
    per = [torch.autograd.grad(bfp_matmul_2d(a, w, pol), (a, w), gg)
           for a, w, gg in zip(xe, we, g)]
    torch.testing.assert_close(gx, torch.stack([p[0] for p in per]),
                               rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(gw, torch.stack([p[1] for p in per]),
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# F10: the gradient at clamp ties
# ---------------------------------------------------------------------------

def test_scalar_bound_ties_split_the_gradient():
    """``torch.maximum`` / ``minimum`` against ``scalar``: the values of
    ``torch.clamp``, and at a tie ``jax.grad``'s 0.5 of ``jnp.clip``."""
    xs = np.array([-3.0, -2.0, -1.0, 0.0, 2.0], np.float32)
    x = t(xs).requires_grad_()
    y = torch.minimum(torch.maximum(x, scalar(-2.0, x)), scalar(0.0, x))
    assert torch.equal(y, torch.clamp(x.detach(), -2.0, 0.0))
    (g,) = torch.autograd.grad(y.sum(), x)
    want = jax.grad(lambda a: jnp.clip(a, -2.0, 0.0).sum())(xs)
    assert_bits_equal(g, np.asarray(want))
    assert g.tolist() == [0.0, 0.5, 1.0, 0.5, 0.0]


def test_rwkv6_logw_clamp_tie_gradient():
    """The chunked WKV's log-decay clip: at w = 1 (log w = 0, the upper
    bound) the gradient splits as ``jnp.clip``'s."""
    h, d = 2, 8
    r, k, v = (normal((1, LC.S, h, d), seed=s, scale=0.5) for s in (1, 2, 3))
    w = np.exp(-np.exp(normal((1, LC.S, h, d), seed=4, scale=0.5))).astype(
        np.float32)
    w[0, ::3, :, ::2] = 1.0                       # ties at log w = 0
    u = normal((h, d), seed=5, scale=0.5)
    gy = normal((1, LC.S, h, d), seed=6)
    want = jax.jit(jax.grad(
        lambda w_: jnp.sum(RW._wkv_chunked(r, k, v, w_, u) * gy)))(w)
    wt = t(w).requires_grad_()
    (got,) = torch.autograd.grad(
        (PW._wkv_chunked(t(r), t(k), t(v), wt, t(u)) * t(gy)).sum(), wt)
    want = np.asarray(want)
    tie = w == 1.0
    np.testing.assert_allclose(got.numpy()[tie], want[tie], rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    LC.assert_float_leaf(got, want)


def test_griffin_softplus_tie_gradient():
    """The RG-LRU's ``softplus(lam)`` at lam = 0: ``jax.nn.softplus``
    (``logaddexp(x, 0)``) has gradient 0.5 there, and so has the port's;
    through ``_rglru`` against the reference's (float policy)."""
    c = 16
    lam = normal((c,), seed=7)
    lam[::2] = 0.0
    p = {"wr": {"w": normal((c, c), seed=8, scale=0.25)},
         "wi": {"w": normal((c, c), seed=9, scale=0.25)}, "lam": lam}
    x = normal((2, 8, c), seed=10)
    gy = normal((2, 8, c), seed=11)
    want = jax.jit(jax.grad(
        lambda q: jnp.sum(RG._rglru(q, x, None, None)[0] * gy)))(p)["lam"]
    pt = {"wr": {"w": t(p["wr"]["w"])}, "wi": {"w": t(p["wi"]["w"])},
          "lam": t(lam).requires_grad_()}
    (got,) = torch.autograd.grad(
        (PG._rglru(pt, t(x), None, None)[0] * t(gy)).sum(), pt["lam"])
    LC.assert_float_leaf(got, np.asarray(want))
    z = torch.zeros(3, requires_grad=True)
    (gz,) = torch.autograd.grad(PG.softplus(z).sum(), z)
    assert gz.tolist() == [0.5] * 3
    assert float(jax.grad(jax.nn.softplus)(0.0)) == 0.5
