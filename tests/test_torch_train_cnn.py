"""The port's data-parallel BFP CNN trainer (``repro_torch.train.cnn``)
against ``repro.train.cnn``, case by case after
``tests/test_train_cnn.py``, plus the parity of one whole step and of the
train state's checkpoint across the two packages.

Contracts: the loss falls (float and BFP); the packed-bytes exchange is
bit-exact to the in-graph model; residuals survive a checkpoint round
trip; the wire bytes are counted honestly; training-time gradient NSR
stays within the bound; a ``CnnTrainState`` checkpoint written by either
package restores in the other (``arrays.npz`` byte-identical, leaves
keyed ``.params...`` as ``jax.tree_util.keystr`` writes them).

Tolerances of the whole-step parity, from the same exported state and
numpy batch: the loss 1e-5 relative (a float log-softmax on both sides,
over bit-exact logits).  Parameters: a last-bit difference in the
cotangent (log-softmax, col2im and the global norm are float reductions
ordered differently by XLA and PyTorch) can move the rounding of a
quantized backward GEMM's block, and AdamW's first update is about
``lr * sign(g)``, so an element whose tiny gradient changes sign may move
by up to ``2 * lr``; every element is held to ``2.5 * lr`` absolute and
all but 1% of them to 1e-5 relative and 1e-5 of the largest magnitude;
the optimizer moments the same, with 1e-3 of the largest magnitude in
place of ``2.5 * lr``.  A residual ``e - Q(e)`` carries the gradient's
own float error, so it is held to 1e-5 of the largest per-worker
gradient of its leaf for all but 1% of elements, and to one 8-bit wire
step of the largest block (``max|g| / 32``) for every element.
"""
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.core.bfp import Scheme as JScheme
from repro.core.policy import BFPPolicy as JPolicy
from repro.engine import PolicyMap as JPolicyMap
from repro.optim import optimizers as jopt
from repro.train import cnn as JTC
from repro_torch import _tree
from repro_torch.checkpoint import store
from repro_torch.convert import params_from_numpy
from repro_torch.core.bfp import Scheme
from repro_torch.core.policy import BFPPolicy
from repro_torch.engine import PolicyMap
from repro_torch.optim import optimizers as opt
from repro_torch.train import cnn as TC
from test_torch_util import normal, t, to_numpy_tree

EQ4_HARD = BFPPolicy(l_w=8, l_i=8, straight_through=False)
LR = 1e-3


def _cfg(**kw):
    base = dict(model="lenet", workers=2, batch=16, lr=LR, grad_bits=8)
    base.update(kw)
    return TC.CnnTrainConfig(**base)


def _lenet_maps(backend=None):
    """TILED blocks LeNet's K's divide (c1 25, the rest 16), straight
    through off: (repro's emulated map, the port's on ``backend``)."""
    def two(bk):
        kw = dict(block_k=bk, straight_through=False)
        port = BFPPolicy(scheme=Scheme.TILED, **kw)
        return (JPolicy(scheme=JScheme.TILED, **kw),
                port if backend is None else port.with_(backend=backend))
    c1, rest = two(25), two(16)
    return (JPolicyMap.of(("^c1$", c1[0]), default=rest[0]),
            PolicyMap.of(("^c1$", c1[1]), default=rest[1]))


def _port_state(js) -> TC.CnnTrainState:
    """repro's CnnTrainState (numpy leaves) as the port's, on the CPU."""
    o = js.opt_state
    return TC.CnnTrainState(
        params=params_from_numpy(js.params, "cpu"),
        opt_state=opt.OptState(step=t(np.asarray(o.step)),
                               mu=params_from_numpy(o.mu, "cpu"),
                               nu=params_from_numpy(o.nu, "cpu")),
        residual=params_from_numpy(js.residual, "cpu"),
        step=t(np.asarray(js.step)))


def _leaves(tree):
    return [np.asarray(leaf.numpy() if isinstance(leaf, torch.Tensor)
                       else leaf) for leaf in _tree.flatten(tree)[0]]


def _tree_equal(a, b) -> bool:
    return all(torch.equal(u, v) for u, v in zip(_tree.flatten(a)[0],
                                                 _tree.flatten(b)[0]))


X = normal((16, 28, 28, 1), seed=5)
Y = np.random.default_rng(6).integers(0, 10, 16).astype(np.int32)


@pytest.fixture(scope="module")
def ref():
    """repro's init state and one in-graph step on (X, Y), jitted, on
    its emulated TILED map (the port runs the same map on the kernel
    backend's plain versions)."""
    jmap = _lenet_maps()[0]
    jcfg = JTC.CnnTrainConfig(model="lenet", workers=2, batch=16, lr=LR,
                              grad_bits=8, policy=jmap)

    def run():
        s0 = JTC.init_state(jcfg)
        s1, metrics = JTC.make_cnn_train_step(jcfg)(s0, (X, Y))
        return s0, s1, metrics

    return to_numpy_tree(jax.jit(run)())


# ---------------------------------------------------------------------------
# after tests/test_train_cnn.py
# ---------------------------------------------------------------------------

def test_config_validates_split_and_wire_block():
    with pytest.raises(ValueError, match="split"):
        TC.CnnTrainConfig(batch=10, workers=4)
    with pytest.raises(ValueError, match="wire block"):
        TC.CnnTrainConfig(grad_bits=8, wire_block=0)


def test_loss_decreases_float_and_bfp():
    out_f = TC.train_cnn(_cfg(policy=None, grad_bits=None), steps=8,
                         eval_batch=64, device="cpu")
    lf = [h["loss"] for h in out_f["history"]]
    assert lf[-1] < lf[0], lf
    out_q = TC.train_cnn(_cfg(policy=EQ4_HARD), steps=8, eval_batch=64,
                         device="cpu")
    lq = [h["loss"] for h in out_q["history"]]
    assert lq[-1] < lq[0], lq
    assert 0.0 <= out_q["accuracy"] <= 1.0


@pytest.mark.parametrize("backend", [None, "pallas"])
def test_packed_exchange_bit_exact_to_in_graph_model(backend):
    pol = EQ4_HARD if backend is None else _lenet_maps(backend)[1]
    cfg = _cfg(policy=pol)
    state = TC.init_state(cfg, device="cpu")
    x, y, _ = TC.data_batch(cfg, 0, device="cpu")
    s_wire, m_wire = TC.packed_exchange_step(cfg, state, (x, y))
    s_model, m_model = TC.make_cnn_train_step(cfg)(state, (x, y))
    assert _tree_equal(s_wire.params, s_model.params)
    assert _tree_equal(s_wire.residual, s_model.residual)
    assert _tree_equal(s_wire.opt_state, s_model.opt_state)
    assert torch.equal(m_wire["loss"], m_model["loss"])
    assert m_wire["wire_bytes"] > 0


def test_packed_exchange_requires_wire_format():
    cfg = _cfg(grad_bits=None)
    state = TC.init_state(cfg, device="cpu")
    x, y, _ = TC.data_batch(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="grad_bits"):
        TC.packed_exchange_step(cfg, state, (x, y))


def test_step_is_deterministic():
    cfg = _cfg(policy=_lenet_maps("pallas")[1])
    state = TC.init_state(cfg, device="cpu")
    x, y, _ = TC.data_batch(cfg, 3, device="cpu")
    a, _ = TC.make_cnn_train_step(cfg)(state, (x, y))
    b, _ = TC.make_cnn_train_step(cfg)(state, (x, y))
    assert _tree_equal(a, b)
    x2, y2, _ = TC.data_batch(cfg, 3, device="cpu")
    assert torch.equal(x, x2) and torch.equal(y, y2)


def test_data_batch_mixes_seed_and_step():
    """F12: a CPU generator keeps the low 32 bits of its seed, so a seed
    of ``(seed << 32) + step`` gave every ``CnnTrainConfig.seed`` the same
    batches.  The pair is mixed by ``SeedSequence``: the same (seed, step)
    gives the same batch, another seed or step another one."""
    def batch(seed, step):
        return TC.data_batch(_cfg(seed=seed), step, device="cpu")[:2]

    x0, y0 = batch(0, 3)
    xa, ya = batch(0, 3)
    assert torch.equal(x0, xa) and torch.equal(y0, ya)
    for seed, step in ((1, 3), (2, 3), (0, 4)):
        x, y = batch(seed, step)
        assert not torch.equal(x, x0), (seed, step)
        assert not torch.equal(y, y0), (seed, step)


def test_residuals_nonzero_and_survive_checkpoint(tmp_path):
    cfg = _cfg(policy=EQ4_HARD)
    out = TC.train_cnn(cfg, steps=2, eval_batch=32,
                       ckpt_dir=str(tmp_path / "ck"), device="cpu")
    state = out["state"]
    assert isinstance(state, TC.CnnTrainState)
    rnorm = sum(float(torch.linalg.norm(r))
                for r in _tree.flatten(state.residual)[0])
    assert rnorm > 0.0
    restored, step = store.restore(str(tmp_path / "ck"), state,
                                   device="cpu")
    assert step == 2
    assert isinstance(restored, TC.CnnTrainState)
    assert isinstance(restored.opt_state, opt.OptState)
    assert _tree_equal(restored, state)


def test_wire_bytes_accounting():
    cfg = _cfg(policy=EQ4_HARD)
    out = TC.train_cnn(cfg, steps=3, packed_wire_steps=2, eval_batch=32,
                       device="cpu")
    wire = out["wire_bytes"]
    assert wire["packed_steps"] == 2
    assert wire["measured_bytes"] >= 2 * wire["per_step_bytes"] * 0.9
    assert wire["ratio"] < 0.3


def test_training_grad_nsr_within_bound():
    cfg = _cfg(policy=_lenet_maps("pallas")[1])
    out = TC.train_cnn(cfg, steps=2, measure_nsr_every=1, eval_batch=32,
                       device="cpu")
    recs = out["nsr_records"]
    assert len(recs) == 16      # 4 sites x (#dx, #dw) x 2 steps
    assert {r.kind for r in recs} == {"conv_dx", "conv_dw", "gemm_dx",
                                      "gemm_dw"}
    assert {r.backend for r in recs} == {"pallas"}
    for r in recs:
        assert r.within_bound, (r.path, r.kind, r.eta_measured, r.eta_bound)


# ---------------------------------------------------------------------------
# against repro
# ---------------------------------------------------------------------------

def _assert_step_close(got, want, lr):
    g, w = np.asarray(got), np.asarray(want)
    assert g.shape == w.shape
    scale = max(np.abs(w).max(), 1e-30)
    far = np.abs(g - w) > 1e-5 * np.abs(w) + 1e-5 * scale
    assert far.mean() <= 0.01, far.mean()
    if lr is not None:
        assert np.abs(g - w).max() <= 2.5 * lr
    else:
        assert np.abs(g - w).max() <= 1e-3 * scale


def _assert_residual_close(got, want, g):
    g_max = np.abs(g).max()
    d = np.abs(np.asarray(got) - np.asarray(want))
    assert (d > 1e-5 * g_max).mean() <= 0.01
    assert d.max() <= g_max / 32


def test_one_step_matches_repro(ref):
    """From repro's exported init state and the same numpy batch: the
    kernel backend's step (plain versions on the CPU) against repro's
    emulated TILED step, under the stated tolerances."""
    js0, js1, jm = ref
    cfg = _cfg(policy=_lenet_maps("pallas")[1])
    s0 = _port_state(js0)
    s1, m = TC.make_cnn_train_step(cfg)(s0, (t(X), t(Y)))
    np.testing.assert_allclose(float(m["loss"]), jm["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), jm["grad_norm"],
                               rtol=1e-4)
    assert int(s1.step) == 1 and int(s1.opt_state.step) == 1
    for got, want in zip(_leaves(s1.params), _leaves(js1.params)):
        _assert_step_close(got, want, LR)
    for tree, jtree in ((s1.opt_state.mu, js1.opt_state.mu),
                        (s1.opt_state.nu, js1.opt_state.nu)):
        for got, want in zip(_leaves(tree), _leaves(jtree)):
            _assert_step_close(got, want, None)
    _, grads = TC._worker_grads(cfg, TC.MODELS["lenet"].apply, s0.params,
                                t(X), t(Y))
    for got, want, g in zip(_leaves(s1.residual), _leaves(js1.residual),
                            _leaves(grads)):
        assert np.abs(want).max() > 0
        _assert_residual_close(got, want, g)


def test_train_state_checkpoint_crosses_packages(ref, tmp_path):
    """repro's CnnTrainState checkpoint restores in the port and the
    port's in repro; the two ``arrays.npz`` are byte-identical, and the
    port names leaves as ``jax.tree_util.keystr`` does."""
    _, js1, _ = ref
    s1 = _port_state(js1)
    jdir, pdir = str(tmp_path / "repro"), str(tmp_path / "port")
    jstore.save(jdir, 1, js1)
    store.save(pdir, 1, s1)
    with open(os.path.join(jdir, "step_00000001", "arrays.npz"), "rb") as f:
        jbytes = f.read()
    with open(os.path.join(pdir, "step_00000001", "arrays.npz"), "rb") as f:
        assert f.read() == jbytes
    got, step = store.restore(jdir, s1, device="cpu")
    assert step == 1 and isinstance(got, TC.CnnTrainState)
    assert _tree_equal(got, s1)
    back, jstep = jstore.restore(pdir, js1)
    assert jstep == 1
    for u, v in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(js1)):
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v))
    paths = []
    _tree.map_with_path(lambda p, _: paths.append(_tree.keystr(p)), s1)
    jpaths = [jax.tree_util.keystr(p) for p, _ in
              jax.tree_util.tree_flatten_with_path(js1)[0]]
    assert sorted(paths) == sorted(jpaths)
    assert ".params['c1']['w']" in paths and ".opt_state.step" in paths
    assert [p for p, _ in zip(jpaths, _tree.flatten(s1)[0])] == jpaths


def test_init_state_layout_matches_repro(ref):
    """The port's fresh state has repro's structure, shapes and dtypes
    (its values come from another generator)."""
    js0 = ref[0]
    s0 = TC.init_state(_cfg(), device="cpu")
    got = [(a.shape, a.dtype) for a in _leaves(s0)]
    assert got == [(np.asarray(a).shape, np.asarray(a).dtype)
                   for a in jax.tree_util.tree_leaves(js0)]
    assert s0._fields == ("params", "opt_state", "residual", "step")
    assert s0.opt_state._fields == jopt.OptState._fields
