"""The port's tile autotuning (``repro_torch.tune``: tables, cache,
autotune, ``bind(tune_cache=)``) against ``repro.tune`` on the CPU.

Contracts held here:
  * the tile tables (``aligned_tile``, ``overflow_cap``,
    ``fallback_tiles``, ``conv_row_tile``) equal ``repro``'s over a grid;
  * cache key strings equal ``repro``'s, and a cache file written by
    either package loads in the other with equal entries (the repo's
    own ``tune_cache.json`` included, read only);
  * a schema bump drops the entries; a corrupt file warns once and acts
    as empty; ``use_cache`` scopes the active cache;
  * ``tune_gemm`` / ``tune_conv`` skip cached sites, store ``repro``'s
    entry layout on the ``"interpret"`` target and keep a free ``bk``
    within ``overflow_cap``;
  * a bound plan activates its cache (hits counted) and serves bits equal
    to ``repro``'s bound Pallas matmul (interpret mode) with the same
    cache; a free-block GEMM whose entry sets ``bk`` gives ``repro``'s
    bits at that ``bk`` (the plain version at that block), not the
    fallback's.  ``repro``'s kernel backend refuses ``block_k=None``
    (its ``_pallas_supports``; the port's too), so the free-block GEMM
    runs through ``kernels.ops`` with the cache active, inside and
    outside the plan's scope.  Convs are not held against ``repro``'s
    Pallas conv, which does not run on this jax (``ROADMAP.md`` R1).
"""
import json
import warnings

import numpy as np
import pytest
import torch

from repro import engine as JEG
from repro.core.policy import PALLAS_TILED as J_PALLAS
from repro.core.policy import TPU_TILED as J_TILED
from repro.kernels import ops as jops
from repro.tune import cache as jcache
from repro.tune import tables as jtables
from repro_torch import engine as EG
from repro_torch.convert import params_from_numpy
from repro_torch.core.policy import PALLAS_TILED, TPU_TILED
from repro_torch.kernels import bfp_matmul as KM
from repro_torch.kernels import ops
from repro_torch.tune import cache as C
from repro_torch.tune import tables as T
from repro_torch.tune.autotune import _hillclimb, tune_conv, tune_gemm
from test_torch_util import assert_bits_equal, normal, t

DIMS = (1, 3, 7, 8, 9, 25, 64, 100, 127, 128, 129, 300, 512, 1000, 4096)


def test_tile_tables_match_repro():
    for d in DIMS:
        for cap in (8, 128, 256):
            assert T.aligned_tile(d, cap) == jtables.aligned_tile(d, cap)
    for l_sum in range(2, 40):
        assert T.overflow_cap(l_sum) == jtables.overflow_cap(l_sum)
    for b in DIMS[::2]:
        for k in DIMS:
            for n in DIMS[::3]:
                for block in (None, 8, 32, 128):
                    for l_sum in (8, 16, 24, 30):
                        assert T.fallback_tiles(b, k, n, block, l_sum) == \
                            jtables.fallback_tiles(b, k, n, block, l_sum)
    for oh in DIMS:
        for ow in DIMS:
            assert T.conv_row_tile(oh, ow) == jtables.conv_row_tile(oh, ow)


def test_cache_keys_match_repro():
    for args in (("gemm", 64, 512, 128, 8, 8, 128, "interpret"),
                 ("conv", 1024, 27, 64, 8, 8, None, "cpu"),
                 ("gemm", 8, 25088, 4096, 8, 4, 0, C.CARD_TARGET)):
        assert C.TuneCache.key(*args) == jcache.TuneCache.key(*args)
    assert C.SCHEMA == jcache.SCHEMA
    assert C.TuneCache.target(True) == jcache.TuneCache.target(True) \
        == "interpret"
    assert C.TuneCache.target(False) == C.CARD_TARGET == "cuda:sm_90:132sm"


ENTRIES = {
    ("gemm", 8, 64, 8, 8, 8, 16, "interpret"):
        {"bm": 8, "bn": 8, "bk": 16, "us": 1.5, "steps": 3},
    ("conv", 1024, 27, 64, 8, 8, None, "interpret"):
        {"t_oh": 2, "bn": 64, "bk": None, "us": 2955.3, "steps": 6},
    ("gemm", 8, 4096, 1000, 8, 8, 128, C.CARD_TARGET):
        {"bm": 32, "bn": 64, "bk": 128, "us": 40.5, "steps": 4}}


@pytest.mark.parametrize("writer", ["repro", "port"])
def test_cache_files_are_interchangeable(tmp_path, writer):
    """A cache saved by either package loads in the other, entries equal;
    the files are byte-identical."""
    files = {}
    for name, mod in (("repro", jcache), ("port", C)):
        c = mod.TuneCache(path=str(tmp_path / f"{name}.json"))
        for key, ent in ENTRIES.items():
            c.store(*key, ent)
        files[name] = c.save()
    assert open(files["repro"]).read() == open(files["port"]).read()
    reader = C if writer == "repro" else jcache
    loaded = reader.TuneCache.load(files[writer])
    assert loaded.entries == {C.TuneCache.key(*k): v
                              for k, v in ENTRIES.items()}
    for key, ent in ENTRIES.items():
        assert loaded.lookup(*key) == ent


def test_repo_tune_cache_loads_equal():
    ours, theirs = C.TuneCache.load("tune_cache.json"), \
        jcache.TuneCache.load("tune_cache.json")
    assert len(ours) > 0 and ours.entries == theirs.entries


def test_schema_bump_and_corrupt_file(tmp_path):
    p = tmp_path / "c.json"
    p.write_text(json.dumps({"schema": C.SCHEMA + 1, "entries": {
        "gemm:b8k64n8:L8.8:bk16:interpret": {"bm": 8}}}))
    assert len(C.TuneCache.load(str(p))) == 0
    assert len(C.TuneCache.load(str(tmp_path / "missing.json"))) == 0
    bad = tmp_path / "bad.json"
    bad.write_text('{"schema": 1, "entries": {')
    with pytest.warns(UserWarning, match="corrupt"):
        assert len(C.TuneCache.load(str(bad))) == 0
    with warnings.catch_warnings():
        warnings.simplefilter("error")          # warned once per path
        assert len(C.TuneCache.load(str(bad))) == 0
    c = C.TuneCache.load(str(bad))
    c.store("gemm", 8, 64, 8, 8, 8, 16, "interpret", {"bm": 8})
    c.save()                                    # re-save replaces it
    assert len(C.TuneCache.load(str(bad))) == 1
    with pytest.raises(ValueError, match="no path"):
        C.TuneCache().save()


def test_use_cache_scoping():
    a, b = C.TuneCache(), C.TuneCache()
    assert C.get_cache() is None
    assert C.lookup_tiles("gemm", 8, 64, 8, 8, 8, 16, True) is None
    with C.use_cache(a):
        assert C.get_cache() is a
        with C.use_cache(b):
            assert C.get_cache() is b
        assert C.get_cache() is a
        with pytest.raises(RuntimeError):
            with C.use_cache(b):
                raise RuntimeError
        assert C.get_cache() is a
    assert C.get_cache() is None
    a.store("gemm", 8, 64, 8, 8, 8, 16, "interpret",
            {"bm": 8, "bn": 16, "bk": 16})
    a.store("conv", 64, 27, 8, 8, 8, None, "interpret",
            {"t_oh": 2, "bn": 8, "bk": None})
    a.store("conv", 64, 27, 8, 8, 8, None, C.CARD_TARGET,
            {"bm": 16, "bn": 32, "bk": 27})
    with C.use_cache(a):
        assert C.lookup_tiles("gemm", 8, 64, 8, 8, 8, 16, True) == (8, 16,
                                                                    16)
        assert C.lookup_tiles("gemm", 8, 64, 8, 8, 8, 16, False) is None
        assert C.lookup_tiles("conv", 64, 27, 8, 8, 8, None, True) == (2, 8)
        assert C.lookup_tiles("conv", 64, 27, 8, 8, 8, None, False) == \
            (16, 32, 27)
    assert (a.hits, a.misses) == (3, 1)


def test_hillclimb_matches_repro():
    from repro.tune.autotune import _hillclimb as j_hill
    cost = {(8,): 5.0, (16,): 3.0, (32,): 4.0, (4,): 6.0}

    def nb(cfg):
        for v in (cfg[0] * 2, cfg[0] // 2):
            if v in (4, 8, 16, 32):
                yield (v,)

    for steps in (1, 2, 3, 12):
        assert _hillclimb((8,), nb, cost.__getitem__, steps) == \
            j_hill((8,), nb, cost.__getitem__, steps)


def test_tune_gemm_and_conv_skip_cached_and_bound_bk():
    cache = C.TuneCache()
    free = TPU_TILED.with_(block_k=None, l_i=12, l_w=14)  # cap 2^6 = 64
    ent = tune_gemm(8, 300, 16, free, cache=cache, max_steps=6, iters=1,
                    device="cpu")
    assert set(ent) == {"bm", "bn", "bk", "us", "steps"}
    assert 1 <= ent["steps"] <= 6
    assert ent["bk"] <= T.overflow_cap(26) == 64
    assert cache.lookup("gemm", 8, 300, 16, 12, 14, None,
                        "interpret") == ent
    pinned = TPU_TILED.with_(block_k=32)
    ent_p = tune_gemm(8, 64, 16, pinned, cache=cache, max_steps=4,
                      iters=1, device="cpu", prequant=True)
    assert ent_p["bk"] == 32
    ent_c = tune_conv(1, 8, 8, 4, 3, 8, TPU_TILED.with_(block_k=12),
                      cache=cache, max_steps=4, iters=1, device="cpu")
    assert set(ent_c) == {"t_oh", "bn", "bk", "us", "steps"}
    assert ent_c["bk"] == 12
    assert cache.lookup("conv", 64, 36, 8, 8, 8, 12, "interpret") == ent_c
    # cached: the tuner returns the stored entry without timing anything
    n = len(cache)
    for fn in (lambda: tune_gemm(8, 300, 16, free, cache=cache,
                                 device="cpu"),
               lambda: tune_conv(1, 8, 8, 4, 3, 8,
                                 TPU_TILED.with_(block_k=12), cache=cache,
                                 device="cpu")):
        h = cache.hits
        assert fn() in (ent, ent_c)
        assert cache.hits == h + 1 and len(cache) == n
    with pytest.raises(ValueError, match="pinned"):
        tune_gemm(8, 64, 16, TPU_TILED.with_(block_k=None),
                  cache=cache, device="cpu", prequant=True)


# --- the tuned kernels path against repro ---------------------------------

X_FC = normal((4, 96), seed=11)
W_FC = normal((96, 24), seed=12, scale=0.1)


def _fc_apply_port(params, x, plan):
    return plan.gemm(x, params["fc"]["w"], path="fc")


@pytest.fixture(scope="module")
def tuned_ref():
    """repro's side: a bound Pallas plan with a tune cache (pinned block
    32) serving the fc, and free-block Pallas matmuls with the cache
    active, at the entry's bk and at the fallback."""
    pol = J_PALLAS.with_(block_k=32, straight_through=False)
    free = J_TILED.with_(block_k=None, straight_through=False)
    cache = jcache.TuneCache()
    cache.store("gemm", 4, 96, 24, 8, 8, 32, "interpret",
                {"bm": 8, "bn": 32, "bk": 32, "us": 1.0, "steps": 1})
    cache.store("gemm", 4, 96, 24, 8, 8, None, "interpret",
                {"bm": 8, "bn": 8, "bk": 32, "us": 1.0, "steps": 1})
    params = {"fc": {"w": W_FC}}
    plan = JEG.bind(params, pol, model_paths=["fc"], tune_cache=cache)
    bound = plan.gemm(X_FC, plan.params["fc"]["w"], path="fc")
    with jcache.use_cache(cache):
        tuned = jops.bfp_matmul(X_FC, W_FC, free)
    untuned = jops.bfp_matmul(X_FC, W_FC, free)
    return (np.asarray(bound), np.asarray(tuned), np.asarray(untuned),
            cache.hits, cache.misses)


def _port_cache():
    cache = C.TuneCache()
    cache.store("gemm", 4, 96, 24, 8, 8, 32, "interpret",
                {"bm": 8, "bn": 32, "bk": 32, "us": 1.0, "steps": 1})
    cache.store("gemm", 4, 96, 24, 8, 8, None, "interpret",
                {"bm": 8, "bn": 8, "bk": 32, "us": 1.0, "steps": 1})
    return cache


def test_bound_plan_with_tune_cache_matches_repro(tuned_ref):
    want_bound, want_tuned, want_untuned, j_hits, _ = tuned_ref
    cache = _port_cache()
    pol = PALLAS_TILED.with_(block_k=32, straight_through=False)
    plan = EG.bind(params_from_numpy({"fc": {"w": W_FC}}, device="cpu"), pol,
                   model_paths=["fc"], device="cpu", tune_cache=cache)
    assert plan.tune_cache is cache and plan.site("fc").prequantized
    got = plan.gemm(t(X_FC), plan.params["fc"]["w"], path="fc")
    assert_bits_equal(got, want_bound)
    assert (cache.hits, cache.misses) == (1, 0) and j_hits >= 1
    # the cache is active only inside bound executions
    assert C.get_cache() is None
    fwd = plan.jit_forward(_fc_apply_port)
    assert_bits_equal(fwd(t(X_FC)), want_bound)
    assert cache.hits == 2
    # a path: loaded at bind, a missing file an empty cache
    assert len(EG.bind(params_from_numpy({"fc": {"w": W_FC}}, device="cpu"), pol,
                       device="cpu",
                       tune_cache="no_such_cache.json").tune_cache) == 0


def test_free_block_gemm_takes_the_tuned_bk(tuned_ref):
    _, want_tuned, want_untuned, _, _ = tuned_ref
    cache = _port_cache()
    free = TPU_TILED.with_(block_k=None, straight_through=False)
    with C.use_cache(cache):
        got = ops.bfp_matmul(t(X_FC), t(W_FC), free)
    assert cache.hits == 1
    assert_bits_equal(got, want_tuned)
    assert_bits_equal(got, KM.bfp_matmul_plain(t(X_FC), t(W_FC), 8, 8, 32))
    untuned = ops.bfp_matmul(t(X_FC), t(W_FC), free)
    assert_bits_equal(untuned, want_untuned)   # the fallback bk: 128
    assert not np.array_equal(want_tuned, want_untuned)
    # inside a bound plan's scope the same entry applies
    plan = EG.bind(params_from_numpy({"fc": {"w": W_FC}}, device="cpu"), None,
                   device="cpu", tune_cache=cache)
    with plan._tuned():
        assert_bits_equal(ops.bfp_matmul(t(X_FC), t(W_FC), free),
                          want_tuned)
    # explicit tiles win over the cache; a pinned block refuses another bk
    with C.use_cache(cache):
        assert_bits_equal(ops.bfp_matmul(t(X_FC), t(W_FC), free,
                                         tiles=(8, 8, 64)),
                          KM.bfp_matmul_plain(t(X_FC), t(W_FC), 8, 8, 64))
    with pytest.raises(ValueError, match="block"):
        ops.bfp_matmul(t(X_FC), t(W_FC), free.with_(block_k=32),
                       tiles=(8, 8, 64))


def test_tune_plan_serves_every_site_from_the_cache():
    """``tune_plan`` tunes each kernel site of a bound plan on its served
    route; a plan bound with that cache then hits on every site of every
    forward, and serves the untuned plan's bits (pinned blocks)."""
    from repro_torch.models.cnn import MODELS
    from repro_torch.serve.cnn import CnnServeEngine
    from repro_torch.tune.autotune import tune_plan

    spec = MODELS["lenet"]
    params = spec.init(torch.Generator().manual_seed(0), device="cpu")
    pol = PALLAS_TILED.with_(block_k=16, straight_through=False)
    x = torch.randn((4, 28, 28, 1),
                    generator=torch.Generator().manual_seed(1))
    plan = EG.bind(params, pol, device="cpu")
    cache = C.TuneCache()
    ents = tune_plan(plan, spec.apply, x, cache=cache, max_steps=2,
                     iters=1)
    assert sorted(ents) == ["c1", "c2", "fc1", "fc2"] == sorted(plan.sites)
    assert all(k.endswith(":interpret") for k in cache.entries)
    tuned = EG.bind(params, pol, device="cpu", tune_cache=cache)
    cache.hits = cache.misses = 0
    logits = {}
    for name, p in (("untuned", plan), ("tuned", tuned)):
        eng = CnnServeEngine(None, spec.apply, p, slots=4, device="cpu")
        reqs = [eng.submit(image=x[i]) for i in range(4)]
        eng.run()
        logits[name] = np.stack([r.logits for r in reqs])
    assert (cache.hits, cache.misses) == (4 * eng.ncalls, 0)
    assert np.array_equal(logits["tuned"], logits["untuned"])
