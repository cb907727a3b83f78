"""Port parity for four API calls that ran on ``repro`` and raised on the
port: ``engine.bind(model_paths=)``, ``Plan.describe()``,
``PolicyMap.with_default`` and ``CnnServeEngine(jit=)``.

Each is held against ``repro`` on the same exported LeNet parameters:
the bound sites (kind, policy, backend, fallback, prequantized), the
leaves a ``model_paths`` restriction prequantizes (bit for bit) and
leaves float, the site table's text, and served logits (the emulated
TILED datapath, bit-exact between the two packages).
"""
import jax
import numpy as np
import pytest
import torch

from repro import engine as JEG
from repro.core.policy import BFPPolicy as JBFPPolicy
from repro.core.policy import TPU_TILED as J_TPU_TILED
from repro.engine import PolicyMap as JPolicyMap
from repro.models.cnn import small as jsmall
from repro.serve.cnn import CnnServeEngine as JCnnServeEngine
from repro_torch import engine as EG
from repro_torch.convert import params_from_numpy
from repro_torch.core.policy import BFPPolicy, TPU_TILED
from repro_torch.core.prequant import is_prequant
from repro_torch.engine import PolicyMap
from repro_torch.models.cnn import small
from repro_torch.serve.cnn import CnnServeEngine
from test_torch_util import assert_bits_equal, normal, to_numpy_tree

#: TILED at block 16: c2 (K = 400) and fc1 (K = 1568) prequantize, c1
#: (K = 25) does not; the emulated backend on both sides
BK16 = dict(block_k=16, straight_through=False)
#: bound paths: two sites the walk finds, one it skips (c1, fc2 are left
#: out) and two it cannot see, one of each kind
MODEL_PATHS = ["c2", "fc1", ("extra/site", "gemm"), ("extra/conv", "conv")]
IMAGES = normal((3, 28, 28, 1), seed=21)


@pytest.fixture(scope="module")
def lenet():
    """LeNet from ``PRNGKey(0)``, exported as numpy."""
    return to_numpy_tree(jax.jit(jsmall.lenet_init)(jax.random.PRNGKey(0)))


def _policy_data(pol):
    """A policy (either package's) as plain data."""
    return (JPolicyMap if type(pol).__module__.startswith("repro.")
            else PolicyMap)(default=pol).to_dict()["default"]


def _site_data(site):
    return (site.kind, None if site.policy is None
            else _policy_data(site.policy), site.backend.name, site.fallback,
            site.prequantized)


@pytest.fixture(scope="module")
def jax_bound(lenet):
    """``repro``'s bind with ``model_paths`` (prequantizing, in one
    compiled program): its sites and its param tree."""
    sites = {}

    def run(p):
        plan = JEG.bind(p, J_TPU_TILED.with_(**BK16), MODEL_PATHS,
                        tree="cnn")
        sites.update(plan.sites)
        return plan.params
    return sites, to_numpy_tree(jax.jit(run)(lenet))


def test_bind_model_paths_restricts_extends_and_scopes_prequant(lenet,
                                                                jax_bound):
    want_sites, want_params = jax_bound
    plan = EG.bind(params_from_numpy(lenet, "cpu"), TPU_TILED.with_(**BK16),
                   MODEL_PATHS, tree="cnn", device="cpu")
    assert set(plan.sites) == set(want_sites) == {
        "c2", "fc1", "extra/site", "extra/conv"}
    for path, site in plan.sites.items():
        assert _site_data(site) == _site_data(want_sites[path]), path
    assert plan.site("extra/conv").kind == "conv"
    assert not plan.site("extra/site").prequantized
    # the restriction scopes prequantization: c2 and fc1 hold the wire
    # format, bit for bit the reference's; c1 and fc2 stay float
    for name in ("c1", "c2", "fc1", "fc2"):
        got, want = plan.params[name]["w"], want_params[name]["w"]
        assert is_prequant(got) == isinstance(want, dict), name
        if is_prequant(got):
            assert_bits_equal(got["m"], want["m"])
            assert_bits_equal(got["s"], want["s"])
        else:
            assert_bits_equal(got, want)
    assert is_prequant(plan.params["c2"]["w"])
    assert not is_prequant(plan.params["c1"]["w"])


def test_bind_without_model_paths_is_unchanged(lenet):
    params = params_from_numpy(lenet, "cpu")
    plan = EG.bind(params, TPU_TILED.with_(**BK16), tree="cnn", device="cpu")
    assert set(plan.sites) == {"c1", "c2", "fc1", "fc2"}
    assert EG.bind(params, TPU_TILED.with_(**BK16), None, tree="cnn",
                   device="cpu").sites.keys() == plan.sites.keys()


@pytest.mark.parametrize("straight_through", [True, False])
def test_describe_matches_repro(lenet, straight_through):
    """The site table, line for line, the bound backward GEMMs of the
    grad column included (float under a straight-through policy, L8/8 on
    the emulated backend otherwise)."""
    jpm = JPolicyMap.of(("^c1$", None), default=JBFPPolicy(
        straight_through=straight_through))
    pm = PolicyMap.of(("^c1$", None), default=BFPPolicy(
        straight_through=straight_through))
    want = JEG.bind(lenet, jpm, tree="cnn", prequantize=False).describe()
    got = EG.bind(params_from_numpy(lenet, "cpu"), pm, tree="cnn",
                  prequantize=False, device="cpu").describe()
    assert len(got.splitlines()) == 4
    assert got == want
    assert ("grad[dx=L8/8@emulated,dw=L8/8@emulated]" in got) == (
        not straight_through)
    assert "[prequant]" not in got and "c1" in got and "float" in got


def test_policy_map_with_default_matches_repro():
    low = dict(l_w=4, l_i=4)
    jpm = JPolicyMap.of(("^fc", JBFPPolicy(**low)), ("^c1$", None))
    pm = PolicyMap.of(("^fc", BFPPolicy(**low)), ("^c1$", None))
    for jdefault, default in ((J_TPU_TILED, TPU_TILED), (None, None)):
        got, want = pm.with_default(default), jpm.with_default(jdefault)
        assert got.to_dict() == want.to_dict()
        assert got.rules == pm.rules and got.default == default
    assert pm.with_default(TPU_TILED).resolve("c2") == TPU_TILED
    assert pm.with_default(TPU_TILED).resolve("c1") is None


def _serve(engine_cls, params, policy, images, **kw):
    eng = engine_cls(params, small.lenet_apply if engine_cls is
                     CnnServeEngine else jsmall.lenet_apply, policy,
                     slots=2, **kw)
    reqs = [eng.submit(image=images[i]) for i in range(len(images))]
    eng.run()
    assert eng.stats["completed"] == len(images) and not eng.stats["failed"]
    return eng, np.stack([r.logits for r in reqs])


def test_serve_engine_jit_flag_matches_repro(lenet):
    """``jit=`` is accepted and kept; ``jit=True`` serves through the
    plan's shared forward, ``jit=False`` through an eager apply of its
    own (so taps see the sites), and both give ``repro``'s logits (its
    engine run eagerly too) bit for bit."""
    # c1 (K = 25) at block 25: the emulated TILED datapath needs bk | K
    pol = PolicyMap.of(("^c1$", TPU_TILED.with_(**{**BK16, "block_k": 25})),
                       default=TPU_TILED.with_(**BK16))
    plan = EG.bind(params_from_numpy(lenet, "cpu"), pol, tree="cnn",
                   prequantize=False, device="cpu")
    images = torch.from_numpy(IMAGES)
    eager, got = _serve(CnnServeEngine, None, plan, images, jit=False,
                        device="cpu")
    shared, got_jit = _serve(CnnServeEngine, None, plan, images,
                             device="cpu")
    assert eager.jit is False and shared.jit is True
    assert shared._fwd is plan.jit_forward(small.lenet_apply)
    assert eager._fwd is not shared._fwd
    assert_bits_equal(torch.from_numpy(got), got_jit)
    jplan = JEG.bind(lenet, JPolicyMap.of(
        ("^c1$", J_TPU_TILED.with_(**{**BK16, "block_k": 25})),
        default=J_TPU_TILED.with_(**BK16)), tree="cnn", prequantize=False)
    _, want = _serve(JCnnServeEngine, None, jplan, IMAGES, jit=False)
    assert_bits_equal(torch.from_numpy(got), want)
