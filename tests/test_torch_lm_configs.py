"""The port's LM configs and LM walker path rules against ``repro``.

Every ``ARCHS`` entry, ``reduced()`` (several sizes), the analytic
parameter counts, ``SHAPES`` and ``cells()`` are equal field for field;
``lm_rule_path`` / ``lm_eligible`` agree on every leaf path of every
architecture's parameter tree (shapes only: ``jax.eval_shape``).
"""
import dataclasses

import jax
import pytest

from repro.configs import base as RB
from repro.configs import registry as RR
from repro.core import prequant as RPQ
from repro.models.lm import model as RM
from repro_torch.configs import base as PB
from repro_torch.configs import registry as PR
from repro_torch.core import prequant as PPQ


def test_archs_equal_field_for_field():
    assert list(PR.ARCHS) == list(RR.ARCHS) and len(PR.ARCHS) == 10
    for name, ref in RR.ARCHS.items():
        port = PR.ARCHS[name]
        assert type(port).__module__.startswith("repro_torch.")
        assert dataclasses.asdict(port) == dataclasses.asdict(ref), name
        assert PR.get(name) is port
        for prop in ("dh", "is_moe", "is_encdec", "sub_quadratic"):
            assert getattr(port, prop) == getattr(ref, prop), (name, prop)
        assert port.param_count() == ref.param_count(), name
        assert port.active_param_count() == ref.active_param_count(), name
    with pytest.raises(KeyError, match="unknown arch"):
        PR.get("gpt-5")


@pytest.mark.parametrize("kw", [
    {}, dict(n_layers=2, d_model=64, d_ff=128, vocab=256),
    dict(n_layers=4, d_model=128, d_ff=256, vocab=512),
    dict(n_layers=3, d_model=96, d_ff=64, vocab=100, lru_width=48)])
def test_reduced_equal(kw):
    for name, ref in RR.ARCHS.items():
        r, p = RB.reduced(ref, **kw), PB.reduced(PR.ARCHS[name], **kw)
        assert dataclasses.asdict(p) == dataclasses.asdict(r), (name, kw)
        assert p.param_count() == r.param_count()
        assert p.active_param_count() == r.active_param_count()


def test_shapes_and_cells_equal():
    assert {k: dataclasses.asdict(v) for k, v in PB.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in RB.SHAPES.items()}
    assert PR.cells() == RR.cells() and len(PR.cells()) == 40


@pytest.mark.parametrize("arch", sorted(RR.ARCHS))
def test_lm_rule_path_and_eligible_on_every_leaf(arch):
    """Every leaf path of the architecture's tree (all ten families,
    stacked, hybrid and encoder-decoder layouts included): the runtime
    path and the GEMM eligibility agree."""
    cfg = RB.reduced(RR.ARCHS[arch])
    shapes = jax.eval_shape(lambda k: RM.init_params(cfg, k),
                            jax.random.PRNGKey(0))
    leaves = jax.tree_util.tree_leaves_with_path(shapes)
    assert leaves
    n_eligible = 0
    for path, _ in leaves:
        keys = RPQ._path_keys(path)
        assert PPQ.lm_eligible(keys) == RPQ.lm_eligible(keys), keys
        assert PPQ.lm_rule_path(keys) == RPQ.lm_rule_path(keys), keys
        n_eligible += RPQ.lm_eligible(keys)
    assert n_eligible > 0


@pytest.mark.parametrize("keys", [
    [], ["w"], ["embed", "e"], ["layers", "moe", "router", "w"],
    ["layers", "moe", "w2"], ["periods", "rec1", "rec", "w1"],
    ["rem", "0", "ffn", "w3", "w"], ["enc", "attn", "wq", "w"],
    ["dec", "xattn", "wo", "w"], ["lm_head", "w"], ["layers", "ln1", "g"],
    ["layers", "attn", "wq", "b"], ["7", "layers", "x", "w"]])
def test_lm_path_rules_on_edge_keys(keys):
    assert PPQ.lm_eligible(keys) == RPQ.lm_eligible(keys)
    assert PPQ.lm_rule_path(keys) == RPQ.lm_rule_path(keys)
