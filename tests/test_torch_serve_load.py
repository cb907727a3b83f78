"""The port's open-loop load driver (``repro_torch.serve.load``) against
``repro.serve.load`` on the CPU: ``tests/test_serve_load.py``'s cases on
the port's LeNet engine, identical Poisson traces, and the same
``LoadReport.row()`` as ``repro``'s engine on the same trace under
virtual time (``call_cost``), in continuous and bucket batching, with
deadlines and shedding.  Virtual time depends only on the arrival times
and the engine's call count, so the rows are equal exactly.
"""
import jax
import numpy as np
import pytest

from repro.core.policy import TPU_TILED as J_TILED
from repro.models.cnn import MODELS as J_MODELS
from repro.serve import load as jload
from repro.serve.cnn import CnnServeEngine as JEngine
from repro.serve.cnn import ImageRequest as JRequest
from repro_torch.convert import params_from_numpy
from repro_torch.core.policy import TPU_TILED
from repro_torch.models.cnn import MODELS
from repro_torch.serve.cnn import CnnServeEngine, ImageRequest
from repro_torch.serve.load import (Arrival, LoadReport, VirtualClock,
                                    poisson_arrivals, run_open_loop)
from test_torch_util import t, to_numpy_tree

POL = TPU_TILED.with_(block_k=None, straight_through=False)
J_POL = J_TILED.with_(block_k=None, straight_through=False)
MIX = [(0.5, "a", {}), (0.5, "b", {"deadline": 0.5})]
TIGHT = [(0.5, "a", {}), (0.5, "b", {"deadline": 0.010})]


@pytest.fixture(scope="module")
def lenet():
    """LeNet params and four images, drawn by repro and exported."""
    spec = J_MODELS["lenet"]
    params = to_numpy_tree(jax.jit(spec.init)(jax.random.PRNGKey(0)))
    imgs = [np.asarray(jax.random.normal(jax.random.PRNGKey(5 + i),
                                         spec.input_shape()))
            for i in range(4)]
    return params, imgs


def _drive(fix, n=10, rate=200.0, seed=1, mix=MIX, port=True, **engine_kw):
    params, imgs = fix
    arrivals = (poisson_arrivals if port else jload.poisson_arrivals)(
        rate, n, mix, seed=seed)
    clock = (VirtualClock if port else jload.VirtualClock)()
    if port:
        eng = CnnServeEngine(params_from_numpy(params, device="cpu"),
                             MODELS["lenet"].apply, POL, slots=4,
                             jit=False, clock=clock, device="cpu",
                             **engine_kw)
        tims = [t(i) for i in imgs]
        req = ImageRequest
    else:
        # jitted: eager JAX compiles op by op; the row depends only on
        # the call count, not on how a forward runs
        eng = JEngine(params, J_MODELS["lenet"].apply, J_POL, slots=4,
                      jit=True, clock=clock, **engine_kw)
        tims, req = imgs, JRequest

    def mk(a):
        return req(rid=a.rid, image=tims[a.rid % len(tims)],
                   deadline=None if a.deadline is None
                   else a.t + a.deadline)

    run = run_open_loop if port else jload.run_open_loop
    return run(eng, arrivals, mk, clock=clock, call_cost=0.002), eng


def test_poisson_arrivals_identical_to_repro():
    for rate, n, mix, seed in ((10.0, 50, MIX, 3), (300.0, 40, TIGHT, 9),
                               (5000.0, 30, MIX, 1)):
        got = poisson_arrivals(rate, n, mix, seed=seed)
        want = jload.poisson_arrivals(rate, n, mix, seed=seed)
        assert [(a.t, a.rid, a.kind, a.payload, a.deadline) for a in got] \
            == [(a.t, a.rid, a.kind, a.payload, a.deadline) for a in want]


def test_poisson_arrivals_deterministic_and_shaped():
    a1 = poisson_arrivals(10.0, 50, MIX, seed=3)
    assert a1 == poisson_arrivals(10.0, 50, MIX, seed=3)
    assert a1 != poisson_arrivals(10.0, 50, MIX, seed=4)
    ts = [a.t for a in a1]
    assert len(a1) == 50 and ts == sorted(ts) and ts[0] > 0
    assert 0.03 < np.mean(np.diff([0.0] + ts)) < 0.3
    assert {a.kind for a in a1} == {"a", "b"}
    for a in a1:
        assert a.deadline == (0.5 if a.kind == "b" else None)
        assert "deadline" not in a.payload and isinstance(a.rid, int)


def test_poisson_arrivals_validation_and_clock():
    with pytest.raises(ValueError, match="rate"):
        poisson_arrivals(0.0, 5, MIX)
    with pytest.raises(ValueError, match="n must"):
        poisson_arrivals(1.0, 0, MIX)
    with pytest.raises(ValueError, match="mix"):
        poisson_arrivals(1.0, 5, [])
    c = VirtualClock(2.0)
    c.advance(0.5)
    assert c() == 2.5
    with pytest.raises(ValueError):
        c.advance(-1.0)


def test_open_loop_accounting(lenet):
    rep, eng = _drive(lenet)
    assert isinstance(rep, LoadReport)
    assert rep.offered == 10
    assert rep.completed + rep.shed + rep.expired + rep.failed == 10
    assert rep.completed == eng.stats["completed"] == 10
    assert rep.p99_ms >= rep.p50_ms > 0
    assert rep.goodput_rps == pytest.approx(rep.completed / rep.duration_s)
    assert rep.calls == eng.ncalls > 0
    row = rep.row()
    assert row["completed"] == 10 and isinstance(row["p99_ms"], float)


def test_virtual_time_is_deterministic(lenet):
    r1, _ = _drive(lenet, n=20, seed=6)
    r2, _ = _drive(lenet, n=20, seed=6)
    assert r1 == r2


def test_shedding_counted_once(lenet):
    rep, eng = _drive(lenet, n=30, rate=5000.0, max_queue=2)
    assert rep.shed > 0 and rep.shed == eng.stats["shed"]
    assert rep.completed + rep.shed + rep.expired + rep.failed == 30


def test_bucket_barrier_loses_on_p99(lenet):
    cont, _ = _drive(lenet, n=40, rate=300.0, seed=9, mix=TIGHT,
                     batching="continuous")
    buck, _ = _drive(lenet, n=40, rate=300.0, seed=9, mix=TIGHT,
                     batching="bucket", max_wait=4)
    assert cont.p99_ms < buck.p99_ms
    assert cont.expired < buck.expired
    assert cont.goodput_rps > buck.goodput_rps


def test_idle_server_jumps_to_next_arrival(lenet):
    params, imgs = lenet
    arrivals = [Arrival(t=float(v), rid=i, kind="a", payload={})
                for i, v in enumerate((1.0, 100.0, 200.0))]
    clock = VirtualClock()
    eng = CnnServeEngine(params_from_numpy(params, device="cpu"),
                         MODELS["lenet"].apply, POL, slots=4, jit=False,
                         clock=clock, device="cpu")
    rep = run_open_loop(eng, arrivals,
                        lambda a: ImageRequest(rid=a.rid, image=t(imgs[0])),
                        clock=clock, call_cost=0.002)
    assert rep.completed == 3 and clock.t >= 200.0 and rep.p99_ms < 1000.0


ROW_CASES = {
    "continuous": dict(n=40, rate=300.0, seed=9, mix=TIGHT,
                       batching="continuous"),
    "bucket": dict(n=40, rate=300.0, seed=9, mix=TIGHT, batching="bucket",
                   max_wait=4),
    "shedding": dict(n=30, rate=5000.0, max_queue=2),
    "bucket-shedding": dict(n=30, rate=3000.0, seed=4, mix=TIGHT,
                            batching="bucket", max_wait=2, max_queue=3),
}


@pytest.mark.parametrize("case", list(ROW_CASES))
def test_report_row_equals_repro(lenet, case):
    got, _ = _drive(lenet, **ROW_CASES[case])
    want, _ = _drive(lenet, port=False, **ROW_CASES[case])
    assert got.row() == want.row()
    assert got.offered == got.completed + got.shed + got.expired + \
        got.failed
