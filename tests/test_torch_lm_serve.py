"""The port's LM serving (``serve.engine``: ``generate``, ``ServeEngine``)
against ``repro`` and against its own contracts.

Against ``repro``: greedy ``generate`` tokens are equal, float and BFP
(``torch_lm_common.check_generate``; more architectures and the engine
in ``test_torch_lm_serve_repro.py``).

The port's counterparts of ``tests/test_serve_continuous.py`` and of the
LM tests of ``tests/test_serve_degrade.py``: submit validation
(``RequestTooLarge``, ``max_new < 1``, an empty prompt, validation before
shedding), expiry before admission with zero calls, staggered chunked
prefill and bucket batching bit-identical to solo serving, ``step()``'s
pending count, the fallback plan, the float retry and no slot leak.
"""
import pytest
import torch

from repro_torch.core import policy as PPOL
from repro_torch.serve.degrade import (DeadlineExceeded, DegradeConfig,
                                       DegradeController, QueueOverloaded,
                                       RequestTooLarge, ServeRejected)
from repro_torch.serve.engine import Request, ServeEngine, generate
from torch_lm_common import cfgs, check_generate, port_params

#: the reference tests' serving policy (TILED, one block per K, emulated)
POL = PPOL.TPU_TILED.with_(block_k=None, straight_through=False)
POL4 = POL.with_(l_w=4, l_i=4)
#: the slice's policy at the test size, on the port's kernel backend
KPOL = PPOL.PALLAS_TILED.with_(block_k=32, straight_through=False)
ARCH = "tinyllama-1.1b"


@pytest.fixture(scope="module")
def lm():
    return cfgs(ARCH)[1], port_params(ARCH)


def _engine(lm, **kw):
    cfg, params = lm
    kw.setdefault("policy", POL)
    return ServeEngine(params, cfg, device="cpu", **kw)


# ---------------------------------------------------------------------------
# against repro (more architectures and the engine: test_torch_lm_serve_repro)
# ---------------------------------------------------------------------------

def test_generate_greedy_matches_repro():
    check_generate(ARCH)


# ---------------------------------------------------------------------------
# submit validation
# ---------------------------------------------------------------------------

def test_submit_rejects_request_too_large(lm):
    eng = _engine(lm, slots=1, max_len=8)
    with pytest.raises(RequestTooLarge) as ei:
        eng.submit(Request(rid=7, prompt=[1, 2, 3, 4, 5], max_new=4))
    assert isinstance(ei.value, ServeRejected) and ei.value.rid == 7
    assert len(eng.table.queue) == 0 and eng.stats["shed"] == 0
    eng.submit(Request(rid=8, prompt=[1, 2, 3, 4, 5], max_new=3))
    done = eng.run()
    assert done[0].error is None and len(done[0].out) == 3


def test_submit_rejects_nonpositive_max_new_and_empty_prompt(lm):
    eng = _engine(lm, slots=1, max_len=16)
    for rid, mn in ((0, 0), (1, -2)):
        with pytest.raises(ValueError, match="max_new"):
            eng.submit(Request(rid=rid, prompt=[1], max_new=mn))
    with pytest.raises(ValueError, match="non-empty"):
        eng.submit(Request(rid=2, prompt=[], max_new=1))
    assert not eng.table.pending()


def test_validation_runs_before_shedding(lm):
    eng = _engine(lm, slots=1, max_len=8, max_queue=1)
    eng.submit(Request(rid=0, prompt=[1], max_new=2))
    with pytest.raises(RequestTooLarge):
        eng.submit(Request(rid=1, prompt=[1] * 8, max_new=8))
    with pytest.raises(QueueOverloaded):
        eng.submit(Request(rid=2, prompt=[1], max_new=2))
    assert eng.stats["shed"] == 1


# ---------------------------------------------------------------------------
# expiry before admission
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batching", ["continuous", "bucket"])
def test_dead_request_is_never_prefilled(lm, batching):
    now = [0.0]
    eng = _engine(lm, slots=1, max_len=64, batching=batching,
                  clock=lambda: now[0])
    calls = [0]
    orig = eng._step

    def counting_step(cache, tok, pos):
        calls[0] += 1
        return orig(cache, tok, pos)

    eng._step = counting_step
    dead = Request(rid=0, prompt=list(range(1, 33)), max_new=4,
                   deadline=5.0)
    eng.submit(dead)
    now[0] = 10.0
    assert eng.step() == 0
    assert dead.done and isinstance(dead.error, DeadlineExceeded)
    assert calls[0] == 0 and eng.ncalls == 0
    assert eng.stats["expired"] == 1 and eng.table.active() == []


def test_live_request_unaffected_by_dead_neighbor(lm):
    now = [0.0]
    eng = _engine(lm, slots=2, max_len=64, clock=lambda: now[0])
    dead = Request(rid=0, prompt=[1, 2, 3], max_new=4, deadline=5.0)
    live = Request(rid=1, prompt=[1, 2, 3], max_new=4, deadline=500.0)
    eng.submit(dead)
    eng.submit(live)
    now[0] = 10.0
    eng.run()
    assert isinstance(dead.error, DeadlineExceeded) and dead.out == []
    assert live.error is None and len(live.out) == 4


# ---------------------------------------------------------------------------
# continuous batching: row independence
# ---------------------------------------------------------------------------

def _solo(lm, prompt, max_new, **kw):
    eng = _engine(lm, slots=1, max_len=64, **kw)
    r = Request(rid=0, prompt=list(prompt), max_new=max_new)
    eng.submit(r)
    eng.run()
    return list(r.out)


@pytest.mark.parametrize("policy", [POL, KPOL], ids=["emulated", "kernels"])
def test_chunked_prefill_staggered_admissions_bit_exact(lm, policy):
    """A long prompt admitted mid-flight prefills in chunks interleaved
    with the active request's decodes; neither request's greedy tokens
    move against solo serving."""
    p_short, p_long = [1, 2, 3], list(range(5, 5 + 24))
    ref_s = _solo(lm, p_short, 8, policy=policy)
    ref_l = _solo(lm, p_long, 8, policy=policy)
    eng = _engine(lm, slots=2, max_len=64, prefill_chunk=2, policy=policy)
    r1 = Request(rid=1, prompt=list(p_short), max_new=8)
    eng.submit(r1)
    eng.step()
    eng.step()
    mid = len(r1.out)
    r2 = Request(rid=2, prompt=list(p_long), max_new=8)
    eng.submit(r2)
    eng.step()
    assert len(r1.out) == mid + 1 and r2.out == []
    while eng.step():
        pass
    assert r1.out == ref_s and r2.out == ref_l


def test_bucket_mode_matches_continuous_tokens(lm):
    prompts = [[1, 2, 3], [9, 8, 7, 6, 5, 4], [11, 12]]
    outs = {}
    for mode in ("continuous", "bucket"):
        eng = _engine(lm, slots=2, max_len=64, batching=mode,
                      prefill_chunk=3)
        rs = [Request(rid=i, prompt=list(p), max_new=5)
              for i, p in enumerate(prompts)]
        for r in rs:
            eng.submit(r)
        eng.run()
        outs[mode] = [r.out for r in rs]
    assert outs["continuous"] == outs["bucket"]
    assert outs["continuous"][1] == _solo(lm, prompts[1], 5)


def test_whole_prompt_chunk_none(lm):
    ref = _solo(lm, [3, 1, 4, 1, 5], 4)
    assert _solo(lm, [3, 1, 4, 1, 5], 4, prefill_chunk=None) == ref


def test_step_returns_pending_after_step(lm):
    eng = _engine(lm, slots=1, max_len=64)
    eng.submit(Request(rid=0, prompt=[1, 2], max_new=2))
    eng.submit(Request(rid=1, prompt=[1, 2], max_new=2))
    seen = []
    while True:
        n = eng.step()
        seen.append(n)
        if not n:
            break
    assert seen[-1] == 0 and seen[0] >= 1
    assert eng.stats["completed"] == 2
    assert eng.step() == 0


def test_engine_rejects_bad_args(lm):
    with pytest.raises(ValueError, match="batching"):
        _engine(lm, slots=1, batching="magic")
    with pytest.raises(ValueError, match="prefill_chunk"):
        _engine(lm, slots=1, prefill_chunk=0)
    with pytest.raises(ValueError, match="max_queue"):
        _engine(lm, slots=1, max_queue=0)


# ---------------------------------------------------------------------------
# degradation: shedding, deadlines, the fallback plan, float retry, leaks
# ---------------------------------------------------------------------------

def test_lm_shed_and_deadline(lm):
    eng = _engine(lm, slots=1, max_len=32, max_queue=1)
    eng.submit(Request(rid=0, prompt=[1], max_new=2))
    with pytest.raises(QueueOverloaded):
        eng.submit(Request(rid=1, prompt=[1], max_new=2))
    assert eng.stats["shed"] == 1
    now = [0.0]
    eng2 = _engine(lm, slots=1, max_len=32, clock=lambda: now[0])
    rd = Request(rid=0, prompt=[1, 2], max_new=10, deadline=5.0)
    eng2.submit(rd)
    eng2.step()
    now[0] = 10.0
    eng2.step()
    assert rd.done and isinstance(rd.error, DeadlineExceeded)
    assert len(rd.out) >= 1 and not eng2.table.pending()


def test_lm_degraded_mode_bit_exact_and_recovers(lm):
    eng = _engine(lm, slots=2, max_len=32, fallback_policy=POL4,
                  degrade=DegradeConfig(queue_high=3, queue_low=0,
                                        trip_steps=1, recover_steps=1))
    assert eng.fallback_plan is not None
    rs = [Request(rid=i, prompt=[1, 2, 3], max_new=4) for i in range(6)]
    for r in rs:
        eng.submit(r)
    eng.run()
    assert all(r.done and r.error is None for r in rs)
    deg = [r for r in rs if r.degraded]
    assert deg and eng.stats["degraded_served"] == len(deg)
    eng_fb = _engine(lm, slots=2, max_len=32, policy=POL4)
    for r in deg[:2]:
        r2 = Request(rid=90 + r.rid, prompt=list(r.prompt),
                     max_new=r.max_new)
        eng_fb.submit(r2)
        eng_fb.run()
        assert r2.out == r.out
    eng.step()
    assert eng.controller.state == DegradeController.PRIMARY
    post = Request(rid=50, prompt=[1, 2], max_new=2)
    eng.submit(post)
    eng.run()
    assert post.done and not post.degraded


def test_lm_float_retry_on_non_finite_logits(lm):
    """A step whose logits are not finite is retried once on the float
    reference of the served weights; the request completes."""
    eng = _engine(lm, slots=1, max_len=32, prequant=KPOL, policy=KPOL)
    orig = eng._step
    boom = [True]

    def nan_step(cache, tok, pos):
        logits, cache2 = orig(cache, tok, pos)
        if boom[0]:
            boom[0] = False
            return torch.full_like(logits, float("nan")), cache2
        return logits, cache2

    eng._step = nan_step
    r = Request(rid=0, prompt=[1, 2], max_new=3)
    eng.submit(r)
    eng.run()
    assert r.error is None and len(r.out) == 3
    assert eng.stats["float_retries"] == 1
    assert eng.ncalls == 2 + 3 + 1      # prompt, decodes, the retry
    fl = _engine(lm, slots=1, max_len=32, policy=None)
    assert eng._float_step_fn() is eng._float_step_fn()
    r2 = Request(rid=1, prompt=[1], max_new=1)
    fl.submit(r2)
    fl.run()
    assert r2.error is None


def test_lm_slot_leak_regression(lm):
    eng = _engine(lm, slots=2, max_len=32)
    boom = [True]
    orig = eng._step

    def flaky_step(cache, tok, pos):
        if boom[0]:
            boom[0] = False
            raise RuntimeError("step boom")
        return orig(cache, tok, pos)

    ra = Request(rid=0, prompt=[1, 2], max_new=3)
    eng.submit(ra)
    eng._step = flaky_step
    eng.run()
    assert ra.done and isinstance(ra.error, RuntimeError)
    assert eng.stats["failed"] == 1
    assert eng.table.active() == [] and not eng.table.pending()
    rb = Request(rid=1, prompt=[1, 2], max_new=3)
    eng.submit(rb)
    eng.run()
    assert rb.done and rb.error is None and len(rb.out) == 3


def test_sampling_draws_from_the_generator(lm):
    """``temperature > 0`` samples from a ``torch.Generator`` (the
    reference's ``jax.random`` stream cannot be reproduced): the same
    seed gives the same tokens, and every token is in the vocabulary."""
    cfg, params = lm
    prompt = torch.tensor([[1, 2, 3]])

    def draw(seed):
        return generate(params, cfg, prompt, 5, temperature=1.0,
                        generator=torch.Generator().manual_seed(seed),
                        device="cpu")
    a, b = draw(0), draw(0)
    assert torch.equal(a, b) and a.shape == (1, 5)
    assert bool(((a >= 0) & (a < cfg.vocab_size)).all())
