"""The port's optimizers and schedules (``repro_torch.optim``) against
``repro.optim`` on the same numpy trees.

Tolerance: every value here is a float reduction or float elementwise
arithmetic that XLA may contract or order differently (the norm's sum,
AdamW's moment and bias-correction chain, the schedules' transcendental
functions): 1e-5 relative and 1e-5 of the largest magnitude, as in
``test_torch_grad_guard.py``.  Non-float leaves pass through both
packages untouched, and a clip that does not bite is the identity bit
for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as jopt
from repro_torch import _tree
from repro_torch.optim import optimizers as opt
from test_torch_util import assert_bits_equal, normal, to_numpy_tree

PARAMS = {"c1": {"w": normal((3, 3, 2, 4), seed=1), "b": normal((4,),
                                                                seed=2)},
          "fc": {"w": normal((16, 5), seed=3, scale=0.3),
                 "b": normal((5,), seed=4)},
          "meta": np.arange(3, dtype=np.int32)}
GRADS = [{"c1": {"w": normal((3, 3, 2, 4), seed=10 + s),
                 "b": normal((4,), seed=20 + s)},
          "fc": {"w": normal((16, 5), seed=30 + s, scale=2.0),
                 "b": normal((5,), seed=40 + s)},
          "meta": np.arange(3, dtype=np.int32)} for s in range(3)]
STEPS = np.arange(0, 40, 3, dtype=np.int32)
SCHEDULES = {"cosine": ((1e-3, 5, 30), {}),
             "wsd": ((2e-3, 4, 10, 12), {"floor_frac": 0.05}),
             "constant": ((3e-4,), {})}


def tt(tree):
    return _tree.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.fixture(scope="module")
def ref():
    """repro's side in one compiled program."""
    def run():
        out = {"norm": jopt.global_norm(GRADS[0])}
        out["clip_small"] = jopt.clip_by_global_norm(GRADS[0], 0.5)
        out["clip_big"] = jopt.clip_by_global_norm(GRADS[0], 1e6)
        p, s = PARAMS, jopt.adamw_init(PARAMS)
        out["adamw_init"] = s
        for g in GRADS:
            p, s = jopt.adamw_update(g, s, p, 1e-2, weight_decay=0.05)
        out["adamw"] = (p, s)
        p, s = {k: v for k, v in PARAMS.items() if k != "meta"}, None
        s = jopt.sgd_init(p)
        for g in GRADS:
            g = {k: v for k, v in g.items() if k != "meta"}
            p, s = jopt.sgd_update(g, s, p, 0.1, momentum=0.8)
        out["sgd"] = (p, s)
        out["sched"] = {name: jax.vmap(getattr(jopt, f"{name}_schedule")(
            *args, **kw))(jnp.asarray(STEPS))
            for name, (args, kw) in SCHEDULES.items()}
        return out

    return to_numpy_tree(jax.jit(run)())


def _close_tree(got, want):
    for g, w in zip(_tree.flatten(got)[0], _tree.flatten(want)[0]):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        if w.dtype.kind != "f":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(
                g, w, rtol=1e-5, atol=1e-5 * max(np.abs(w).max(), 1e-30))


def test_global_norm_matches_repro(ref):
    got = opt.global_norm(tt(GRADS[0]))
    np.testing.assert_allclose(got.numpy(), ref["norm"], rtol=1e-5)


def test_clip_by_global_norm_matches_repro(ref):
    clipped, norm = opt.clip_by_global_norm(tt(GRADS[0]), 0.5)
    _close_tree(clipped, ref["clip_small"][0])
    np.testing.assert_allclose(norm.numpy(), ref["clip_small"][1],
                               rtol=1e-5)
    np.testing.assert_allclose(float(opt.global_norm(clipped)), 0.5,
                               rtol=1e-5)
    # a clip that does not bite is the identity, bit for bit
    same, _ = opt.clip_by_global_norm(tt(GRADS[0]), 1e6)
    for g, w in zip(_tree.flatten(same)[0],
                    _tree.flatten(ref["clip_big"][0])[0]):
        assert_bits_equal(g, w)


def test_adamw_init_matches_repro(ref):
    s = opt.adamw_init(tt(PARAMS))
    assert isinstance(s, opt.OptState) and s._fields == ("step", "mu",
                                                         "nu")
    assert s.step.dtype == torch.int32 and int(s.step) == 0
    for got, want in zip(_tree.flatten(s)[0],
                         _tree.flatten(ref["adamw_init"])[0]):
        assert_bits_equal(got, want)
    # the int leaf passes through as itself
    assert s.mu["meta"].dtype == torch.int32


def test_adamw_three_steps_match_repro(ref):
    p, s = tt(PARAMS), opt.adamw_init(tt(PARAMS))
    for g in GRADS:
        p, s = opt.adamw_update(tt(g), s, p, 1e-2, weight_decay=0.05)
    want_p, want_s = ref["adamw"]
    _close_tree(p, want_p)
    _close_tree(s, want_s)
    assert int(s.step) == 3
    assert_bits_equal(p["meta"], PARAMS["meta"])


def test_sgd_three_steps_match_repro(ref):
    p = tt({k: v for k, v in PARAMS.items() if k != "meta"})
    s = opt.sgd_init(p)
    assert s.nu is None
    for g in GRADS:
        p, s = opt.sgd_update(tt({k: v for k, v in g.items()
                                  if k != "meta"}), s, p, 0.1, momentum=0.8)
    want_p, want_s = ref["sgd"]
    _close_tree(p, want_p)
    _close_tree(s.mu, want_s.mu)
    assert int(s.step) == int(want_s.step) == 3 and want_s.nu is None


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_repro(ref, name):
    args, kw = SCHEDULES[name]
    f = getattr(opt, f"{name}_schedule")(*args, **kw)
    got = np.array([float(f(torch.tensor(int(s), dtype=torch.int32)))
                    for s in STEPS], np.float32)
    np.testing.assert_allclose(got, ref["sched"][name], rtol=1e-5,
                               atol=1e-12)
