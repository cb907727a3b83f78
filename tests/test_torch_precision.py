"""The port's per-site mantissa-width search (``repro_torch.tune.
precision``) against ``repro.tune.precision`` on the CPU.

``repro``'s search runs once per module on LeNet (batch 4, budget 5e-3,
as ``tests/test_packed_v2.py``); the port's runs on the same params and
images (``repro``'s own draws, exported).  Bit-exact datapaths make the
width decisions equal, so the emitted ``PolicyMap``, ``n_evals`` and the
top-1 agreement must be equal.  The per-site NSRs are float64 sums in a
different order (the port sums on the tensors' device), so they agree to
1e-5 relative (``tests/test_torch_nsr.py``'s tolerance); a site whose
NSR sits within that of the budget could flip a width, and then the
assertion names it.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.models.cnn import MODELS as J_MODELS
from repro.tune.precision import search_precision as j_search
from repro_torch.convert import params_from_numpy
from repro_torch.core.policy import PALLAS_TILED, TPU_TILED
from repro_torch.engine import PolicyMap
from repro_torch.models.cnn import MODELS
from repro_torch.tune.precision import (PrecisionSearchError,
                                        _bound_operands, search_precision)
from test_torch_util import t, to_numpy_tree

BUDGET = 5e-3
RTOL = 1e-5


@pytest.fixture(scope="module")
def ref():
    """repro's search and the params / images it drew."""
    spec = J_MODELS["lenet"]
    params = to_numpy_tree(jax.jit(lambda k: spec.init(k, reduced=True))(
        jax.random.PRNGKey(0)))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                     (4, *spec.input_shape(reduced=True))))
    res = j_search("lenet", seed=0, batch=4, nsr_budget=BUDGET)
    return res, params, x


@pytest.fixture(scope="module")
def port(ref):
    _, params, x = ref
    return search_precision("lenet", seed=0, batch=4, nsr_budget=BUDGET,
                            params=params_from_numpy(params, device="cpu"),
                            x=t(x), device="cpu")


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def test_search_matches_repro(ref, port):
    want = ref[0]
    assert port.policy_map.to_dict() == want.policy_map.to_dict()
    assert port.n_evals == want.n_evals
    assert port.top1_agreement == want.top1_agreement
    assert [s.path for s in port.sites] == [s.path for s in want.sites]
    for got, w in zip(port.sites, want.sites):
        assert (got.kind, got.l_w) == (w.kind, w.l_w), got.path
        for field in ("nsr_measured", "nsr_fresh", "nsr_bound"):
            assert _rel(getattr(got, field), getattr(w, field)) <= RTOL, \
                (got.path, field, getattr(got, field), getattr(w, field))
        # no site sits within the tolerance of the budget (a tie there
        # could flip a width)
        assert _rel(w.nsr_measured, BUDGET) > RTOL, got.path
    d, wd = port.to_dict(), want.to_dict()
    assert set(d) == set(wd)
    for key in ("model", "seed", "l_max", "l_min", "nsr_budget",
                "top1_tol", "top1_agreement", "n_evals", "policy_map"):
        assert d[key] == wd[key], key


def test_search_meets_budget_and_bounds(port, tmp_path):
    assert port.sites
    for s in port.sites:
        assert port.l_min <= s.l_w <= port.l_max
        assert s.nsr_measured <= port.nsr_budget
        assert s.nsr_fresh <= s.nsr_bound
        assert port.policy_map.resolve(s.path).l_w == s.l_w
    assert port.top1_agreement >= 1.0 - port.top1_tol
    assert PolicyMap.from_dict(port.policy_map.to_dict()) == port.policy_map
    path = tmp_path / "policy.json"
    port.save(str(path))
    assert json.loads(path.read_text()) == json.loads(
        json.dumps(port.to_dict()))


def test_search_is_deterministic():
    a = search_precision("lenet", seed=3, batch=4, nsr_budget=BUDGET,
                         device="cpu")
    b = search_precision("lenet", seed=3, batch=4, nsr_budget=BUDGET,
                         device="cpu")
    assert a.to_dict() == b.to_dict()
    # a seed draws its params and images from torch.Generator streams
    params = MODELS["lenet"].init(torch.Generator().manual_seed(3),
                                  device="cpu")
    x = torch.randn((4, 28, 28, 1),
                    generator=torch.Generator().manual_seed(4))
    c = search_precision("lenet", seed=3, batch=4, nsr_budget=BUDGET,
                         params=params, x=x, device="cpu")
    assert c.to_dict() == a.to_dict()


def test_unsatisfiable_budget_and_bad_arguments():
    with pytest.raises(PrecisionSearchError, match="unsatisfiable"):
        search_precision("lenet", batch=2, nsr_budget=0.0, device="cpu")
    for kw, match in (({"l_min": 1}, "l_min"), ({"l_min": 9}, "l_min"),
                      ({"l_max": 25}, "l_max"),
                      ({"nsr_budget": -1.0}, "nsr_budget")):
        with pytest.raises(ValueError, match=match):
            search_precision("lenet", device="cpu", **kw)
    with pytest.raises(ValueError, match="unknown model"):
        search_precision("alexnet", device="cpu")


def test_kernel_backend_search_on_reduced_vgg16():
    """The card's configuration at reduced width on the plain versions:
    a kernel policy (block 128), conv1_1's K = 27 not a block multiple,
    every site's fresh NSR within its bound, the bound taken over the
    kernels' zero-padded K-tiles there."""
    res = search_precision("vgg16", batch=4, nsr_budget=1e-2, top1_tol=0.25,
                           base_policy=PALLAS_TILED, device="cpu")
    assert len(res.sites) == 16
    assert res.policy_map.default.backend_name == "pallas"
    for s in res.sites:
        assert s.nsr_measured <= 1e-2 and s.nsr_fresh <= s.nsr_bound, s
    assert res.assignment["conv1_1"] >= 2
    x = torch.ones(3, 27)
    w = torch.ones(27, 5)
    xp, wp = _bound_operands(x, w, PALLAS_TILED)
    assert xp.shape == (3, 128) and wp.shape == (128, 5)
    assert _bound_operands(x, w, TPU_TILED.with_(block_k=None))[0] is x
