"""``repro_torch.serve.tenants`` (and packed leaves through ``bind`` and
``float_params``) against ``repro.serve.tenants``.

A ``bfp_packed`` LeNet artifact cold-starts a tenant that keeps its
``PackedBFP`` leaves and draws nothing (the template is the registered
init on the meta device); a missing checkpoint raises; a tenant is
bit-equal to a solo engine on its plan and to the ``packed="prequant"``
restore path; tenants on one plan share one forward; several models
share a process with per-tenant and rolled-up stats.  And a
``repro``-written artifact served by the port gives ``repro``'s tenant
logits on the same images, bit for bit (the whole-K TILED policy runs
the emulated integer datapath, exact in both packages).
"""
import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.core.policy import TPU_TILED as J_TPU_TILED
from repro.serve.tenants import MultiTenantServer as JMultiTenantServer
from repro_torch import _tree
from repro_torch import engine as EG
from repro_torch.checkpoint import store
from repro_torch.core import packed
from repro_torch.core.policy import TPU_TILED
from repro_torch.engine.plan import unpack_packed
from repro_torch.models.cnn import MODELS
from repro_torch.serve.cnn import CnnServeEngine
from repro_torch.serve.degrade import QueueOverloaded, float_params
from repro_torch.serve.tenants import MultiTenantServer, cold_start
from test_torch_util import assert_bits_equal, normal, t

POL = TPU_TILED.with_(block_k=None, straight_through=False)
J_POL = J_TPU_TILED.with_(block_k=None, straight_through=False)


@pytest.fixture(scope="module")
def packed_ckpt(tmp_path_factory):
    """A bfp_packed LeNet artifact written by the port, and its params."""
    params = MODELS["lenet"].init(torch.Generator().manual_seed(0),
                                  device="cpu")
    base = str(tmp_path_factory.mktemp("tenants") / "lenet")
    store.save(base, 1, params, format="bfp_packed", policy=POL,
               tree_kind="cnn")
    return MODELS["lenet"], params, base


def _imgs(spec, n, seed=1):
    return t(normal((n, *spec.input_shape()), seed=seed))


def test_cold_start_keeps_packed_leaves_and_draws_nothing(packed_ckpt,
                                                          monkeypatch):
    _, params, base = packed_ckpt

    def no_draw(*a, **k):
        raise AssertionError("cold start drew a float init")

    monkeypatch.setattr(torch, "randn", no_draw)
    got = cold_start("lenet", base, device="cpu")
    leaves = _tree.flatten(got, is_leaf=packed.is_packed)[0]
    assert sum(packed.is_packed(x) for x in leaves) == 4
    assert got["c1"]["b"].device.type == "cpu"
    assert torch.equal(got["c1"]["b"], params["c1"]["b"])
    monkeypatch.undo()
    # bind unpacks the containers onto the plan's device
    side = unpack_packed(got, "cpu")
    bound = EG.bind(params, POL, device="cpu").params
    for a, b in zip(_tree.flatten(side)[0], _tree.flatten(bound)[0]):
        assert torch.equal(a, b)
    assert unpack_packed(params, "cpu") is params
    # the float retry tree dequantizes containers and sidecars alike
    for a, b in zip(_tree.flatten(float_params(got, "cpu"))[0],
                    _tree.flatten(float_params(bound, "cpu"))[0]):
        assert torch.equal(a, b)


def test_cold_start_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="lenet"):
        cold_start("lenet", str(tmp_path / "nope"), device="cpu")


def test_tenant_bit_equal_to_a_solo_engine(packed_ckpt):
    spec, _, base = packed_ckpt
    imgs = _imgs(spec, 4)
    srv = MultiTenantServer(jit=True, device="cpu")
    ten = srv.add_tenant("a", "lenet", checkpoint_dir=base, policy=POL,
                         slots=4)
    got = [srv.submit("a", image=imgs[i]) for i in range(4)]
    srv.run()
    solo = CnnServeEngine(None, spec.apply, ten.plan, slots=4, device="cpu")
    want = [solo.submit(image=imgs[i]) for i in range(4)]
    solo.run()
    for g, w in zip(got, want):
        assert g.error is None
        np.testing.assert_array_equal(g.logits, w.logits)
        assert g.label == w.label
    assert all(s.prequantized for s in ten.plan.sites.values())


def test_tenants_on_one_plan_share_the_forward(packed_ckpt):
    spec, _, base = packed_ckpt
    srv = MultiTenantServer(jit=True, device="cpu")
    a = srv.add_tenant("a", "lenet", checkpoint_dir=base, policy=POL,
                       slots=2)
    b = srv.add_tenant("b", "lenet", plan=a.plan, slots=2)
    assert b.plan is a.plan
    assert a.engine._fwd is b.engine._fwd
    assert a.engine._fwd is a.plan.jit_forward(spec.apply)
    img = _imgs(spec, 1, seed=3)[0]
    ra, rb = srv.submit("a", image=img), srv.submit("b", image=img)
    srv.run()
    np.testing.assert_array_equal(ra.logits, rb.logits)
    assert srv.stats()["total"]["completed"] == 2


def test_multi_model_tenants_and_aggregate_stats(packed_ckpt):
    spec_l, _, base = packed_ckpt
    spec_c = MODELS["cifarnet"]
    srv = MultiTenantServer(jit=False, device="cpu")
    srv.add_tenant("lenet", "lenet", checkpoint_dir=base, policy=POL,
                   slots=2)
    srv.add_tenant("cifar", "cifarnet", params=spec_c.init(
        torch.Generator().manual_seed(0), device="cpu"), policy=POL,
        slots=2, max_queue=2)
    rl = [srv.submit("lenet", image=i) for i in _imgs(spec_l, 3)]
    rc = [srv.submit("cifar", image=i) for i in _imgs(spec_c, 2)]
    with pytest.raises(QueueOverloaded):
        srv.submit("cifar", image=_imgs(spec_c, 1)[0])
    assert srv.pending() == 5
    assert len(srv.run()) == 5
    assert srv.pending() == 0
    assert all(r.error is None for r in rl + rc)
    st = srv.stats()
    assert st["tenants"]["lenet"]["completed"] == 3
    assert st["tenants"]["cifar"]["completed"] == 2
    assert st["tenants"]["cifar"]["shed"] == 1
    assert st["total"]["completed"] == 5 and st["total"]["shed"] == 1


def test_add_tenant_arg_validation(packed_ckpt):
    spec, params, base = packed_ckpt
    srv = MultiTenantServer(device="cpu")
    ten = srv.add_tenant("a", "lenet", checkpoint_dir=base, policy=POL)
    with pytest.raises(ValueError, match="already registered"):
        srv.add_tenant("a", "lenet", checkpoint_dir=base)
    with pytest.raises(ValueError, match="plan= alone"):
        srv.add_tenant("b", "lenet", plan=ten.plan, checkpoint_dir=base)
    with pytest.raises(ValueError, match="not both"):
        srv.add_tenant("c", "lenet", checkpoint_dir=base, params=params)
    assert srv["a"] is ten


def test_tenant_logits_match_the_prequant_restore_path(packed_ckpt):
    spec, params, base = packed_ckpt
    img = _imgs(spec, 1, seed=9)[0]
    srv = MultiTenantServer(jit=False, device="cpu")
    srv.add_tenant("a", "lenet", checkpoint_dir=base, policy=POL, slots=1)
    r = srv.submit("a", image=img)
    srv.run()
    ref_params, _ = store.restore(base, params, packed="prequant",
                                  device="cpu")
    eng = CnnServeEngine(ref_params, spec.apply, POL, slots=1, jit=False,
                         prequant=False, device="cpu")
    ref = eng.submit(image=img)
    eng.run()
    np.testing.assert_array_equal(r.logits, ref.logits)


@pytest.mark.parametrize("fmt", ["bfp_packed", "bfp_packed_v2"])
def test_repro_artifact_served_by_the_port_equals_repro(tmp_path, fmt):
    """A ``repro``-written artifact, cold-started in each package: the
    port's tenant logits equal ``repro``'s tenant logits, bit for bit."""
    from repro.models.cnn import MODELS as JMODELS
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(JMODELS["lenet"].init)(jax.random.PRNGKey(0)))
    base = str(tmp_path / "lenet")
    jstore.save(base, 3, params, format=fmt, policy=J_POL, tree_kind="cnn")
    imgs = normal((3, 28, 28, 1), seed=5)
    jsrv = JMultiTenantServer(jit=True)
    jsrv.add_tenant("a", "lenet", checkpoint_dir=base, policy=J_POL,
                    slots=4)
    want = [jsrv.submit("a", image=imgs[i]) for i in range(3)]
    jsrv.run()
    srv = MultiTenantServer(jit=True, device="cpu")
    srv.add_tenant("a", "lenet", checkpoint_dir=base, policy=POL, slots=4)
    got = [srv.submit("a", image=t(imgs[i])) for i in range(3)]
    srv.run()
    assert_bits_equal(np.stack([g.logits for g in got]),
                      np.stack([np.asarray(w.logits) for w in want]))
    assert [g.label for g in got] == [w.label for w in want]
