"""The port's LM data stream, training loop and launcher
(``repro_torch.data.pipeline``'s ``lm_batch`` / ``host_shard``,
``repro_torch.train.loop``, ``repro_torch.launch.train``) against
``repro``, case by case after ``tests/test_system.py``; and ``lm_loss``
with its gradients for the recurrent families and the encoder-decoder
under the float policy (RWKV6; RecurrentGemma at 2, 3 and 5 layers: no
(rec, rec, attn) period and a remainder of two rec blocks, one period
and no remainder, one period and the remainder; seamless), under
``test_torch_lm_train.py``'s rules and with its helpers
(``torch_lm_common``); and the datapath under training: TinyLlama's
tapped forward and backward GEMMs bit-equal to ``repro``'s integer
datapath, and its step unchanged by how the stacked layers are viewed
(LM7).  The same families under BFP policies are in
``test_torch_lm_train_recurrent.py`` and ``test_torch_lm_train_taps.py``.
RWKV6's chunked WKV needs S % 32 == 0: the parity batch is B = 2,
S = 32.

The LM stream's recurrence is bit-equal to ``repro``'s when it is fed
``repro``'s own draws; the port's batches themselves come from a
``torch.Generator`` and differ from ``repro``'s for the same seed.  A
``TrainState`` checkpoint written by ``repro``'s ``run_training``
resumes in the port's: the artifacts are the same.
"""
import contextlib
import io
import time

import jax
import numpy as np
import pytest
import torch

import torch_lm_common as LC
from repro.checkpoint import store as rstore
from repro.data import pipeline as RP
from repro.optim import optimizers as ropt
from repro.train import loop as RL
from repro.train import step as RS
from repro_torch import _tree
from repro_torch.checkpoint import store
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import ARCHS
from repro_torch.data import pipeline as PP
from repro_torch.launch import train as train_cli
from repro_torch.optim import optimizers as opt
from repro_torch.train import loop as PL
from repro_torch.train import step as PS
from test_torch_util import t

#: the recurrent families and the encoder-decoder under the float policy
#: (see ``test_torch_lm_train.CASES``), every depth of the hybrid's
#: layouts
CASES = [("rwkv6-3b", 2, "float"), ("recurrentgemma-9b", 2, "float"),
         ("recurrentgemma-9b", 3, "float"), ("recurrentgemma-9b", 5, "float"),
         ("seamless-m4t-medium", 2, "float")]


@pytest.mark.parametrize("arch,n_layers,kind", CASES)
def test_loss_and_grads_match_repro(arch, n_layers, kind):
    grads = LC.check_loss_and_grads(arch, n_layers, kind, "emulated")
    if arch == "recurrentgemma-9b":
        # the empty layouts get zero gradients of their own shapes
        periods = _tree.flatten(grads["periods"])[0]
        assert all(g.shape[0] == (n_layers >= 3) for g in periods)
        assert len(grads["rem"]) == (0 if n_layers == 3 else 2)


# ---------------------------------------------------------------------------
# the datapath under training (TinyLlama, test_torch_lm_train.py's cases)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["emulated", "pallas"])
def test_tapped_backward_gemms_bit_equal_repro(backend):
    """TinyLlama without straight-through: every forward and backward
    GEMM the port taps (15 sites, #dx and #dw each) equals the
    reference's integer datapath on the tapped operands under the
    tapped (fitted) policy, bit for bit; the kernel backend's operands
    are the emulated backend's."""
    LC.check_tapped("tinyllama-1.1b", 2, backend, n_sites=15)


@pytest.mark.parametrize("kind", ["float", "hard"])
def test_unbound_layers_keep_the_step_bits(monkeypatch, kind):
    """``model._layers`` unbinds each stacked leaf once per forward; the
    former per-layer ``t[i]`` selects (whose backward writes a zero
    ``[L, ...]`` tensor per layer) give the same step bit for bit."""
    from repro_torch.models.lm import model as PM

    def select_layers(stacked):
        leaves = _tree.flatten(stacked)[0]
        n = leaves[0].shape[0] if leaves else 0
        return n, lambda i: _tree.tree_map(lambda a: a[i], stacked)

    pcfg = LC.cfgs("tinyllama-1.1b")[1]
    step = PS.make_train_step(pcfg,
                              policy=LC.port_policy(kind, "pallas"))
    p = LC.port_train_params("tinyllama-1.1b")
    batch = (t(LC.TOKENS), t(LC.TARGETS))
    a, ma = step(LC.port_train_state(p, 0), batch)
    monkeypatch.setattr(PM, "_layers", select_layers)
    b, mb = step(LC.port_train_state(p, 0), batch)
    assert all(torch.equal(u, v) for u, v in zip(_tree.flatten(a)[0],
                                                 _tree.flatten(b)[0]))
    assert all(torch.equal(ma[k], mb[k]) for k in ma)


# ---------------------------------------------------------------------------
# the LM stream
# ---------------------------------------------------------------------------

SPEC = dict(vocab_size=256, seq_len=64, global_batch=8)


@pytest.mark.parametrize("seed,step,vocab", [(0, 0, 256), (3, 7, 1000)])
def test_lm_stream_recurrence_bit_equal_given_repro_draws(seed, step, vocab):
    """``lm_tokens`` on ``repro``'s draws (``fold_in(PRNGKey(seed),
    step)`` split in 3: seed tokens, the 5% noise mask, noise tokens)
    gives ``repro.data.pipeline.lm_batch``'s tokens; targets roll by one,
    the last wrapping round."""
    spec = dict(SPEC, vocab_size=vocab, seed=seed)
    p = min(512, vocab)
    b, s = spec["global_batch"], spec["seq_len"]
    k1, k2, k3 = jax.random.split(
        jax.random.fold_in(jax.random.PRNGKey(seed), step), 3)
    t0 = np.asarray(jax.random.randint(k1, (b, 2), 0, p))
    noise = np.asarray(jax.random.uniform(k2, (b, s)) < 0.05)
    noise_tok = np.asarray(jax.random.randint(k3, (b, s), 0, p))
    want_tk, want_tg = RP.lm_batch(RP.LMBatchSpec(**spec), step)
    got = PP.lm_tokens(t(t0), t(noise), t(noise_tok), p)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_tk))
    tk, tg = PP.lm_batch(PP.LMBatchSpec(**spec), step, device="cpu")
    assert tk.dtype == tg.dtype == torch.int32 and tk.shape == (b, s)
    assert torch.equal(tg, torch.roll(tk, -1, dims=1))
    assert torch.equal(tg[:, -1], tk[:, 0])
    np.testing.assert_array_equal(np.roll(np.asarray(want_tk), -1, 1),
                                  np.asarray(want_tg))


def test_lm_batch_deterministic_in_seed_and_step():
    spec = PP.LMBatchSpec(**SPEC)
    a1, b1 = PP.lm_batch(spec, 7, device="cpu")
    a2, b2 = PP.lm_batch(spec, 7, device="cpu")
    assert torch.equal(a1, a2) and torch.equal(b1, b2)
    assert not torch.equal(a1, PP.lm_batch(spec, 8, device="cpu")[0])
    other = PP.LMBatchSpec(**SPEC, seed=1)
    assert not torch.equal(a1, PP.lm_batch(other, 7, device="cpu")[0])
    assert int(a1.min()) >= 0 and int(a1.max()) < 256
    # the pattern is learnable: most tokens follow the recurrence
    t = a1.long()
    pred = (5 * t[:, 1:-1] + 3 * t[:, :-2] + 7) % 256
    assert (pred == t[:, 2:]).float().mean() > 0.85


def test_host_shard(monkeypatch):
    """Rank and world size of ``torch.distributed`` when initialised, 0
    and 1 otherwise; explicit values as ``repro``'s."""
    assert PP.host_shard(8) == slice(0, 8)
    for pi, pc in ((0, 1), (1, 4), (3, 4)):
        assert PP.host_shard(8, pi, pc) == RP.host_shard(8, pi, pc)
    dist = torch.distributed
    monkeypatch.setattr(dist, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda *a, **k: 2)
    monkeypatch.setattr(dist, "get_world_size", lambda *a, **k: 4)
    assert PP.host_shard(8) == slice(4, 6) == RP.host_shard(8, 2, 4)
    assert PP.host_shard(8, 0) == slice(0, 2)


# ---------------------------------------------------------------------------
# the loop, after tests/test_system.py
# ---------------------------------------------------------------------------

CFG = reduced(ARCHS["tinyllama-1.1b"], n_layers=2, d_model=64, d_ff=128,
              vocab=256)


def _state():
    return PS.init_state(CFG, torch.Generator().manual_seed(0),
                         device="cpu")


def _spec():
    return PP.LMBatchSpec(vocab_size=CFG.vocab_size, seq_len=64,
                          global_batch=8)


def _same(a, b) -> bool:
    la, lb = _tree.flatten(a)[0], _tree.flatten(b)[0]
    return len(la) == len(lb) and all(torch.equal(u, v)
                                      for u, v in zip(la, lb))


def test_loss_decreases():
    """~40 steps on the synthetic pattern cut the loss visibly."""
    step = PS.make_train_step(CFG, opt.cosine_schedule(3e-3, 5, 60))
    out = PL.run_training(_state(), step, _spec(),
                          PL.LoopConfig(total_steps=40))
    first = np.mean([h["loss"] for h in out["history"][:5]])
    last = np.mean([h["loss"] for h in out["history"][-5:]])
    assert last < first - 0.2, (first, last)
    assert int(out["state"].step) == 40 and out["median_step_s"] > 0


def test_checkpoint_roundtrip_and_resume(tmp_path):
    step = PS.make_train_step(CFG)
    d = str(tmp_path)
    PL.run_training(_state(), step, _spec(),
                    PL.LoopConfig(total_steps=10, ckpt_dir=d, ckpt_every=5))
    # resume continues from step 10 and runs 5 more
    out2 = PL.run_training(_state(), step, _spec(),
                           PL.LoopConfig(total_steps=15, ckpt_dir=d,
                                         ckpt_every=5))
    assert len(out2["history"]) == 5
    assert store.latest_step(d) == 15
    assert int(out2["state"].step) == 15


def _landed(d, step, timeout=60.0):
    """The latest valid step of ``d`` once ``step`` has landed: the save
    the crash left in flight finishes in the background."""
    deadline = time.monotonic() + timeout
    while store.latest_step(d) != step and time.monotonic() < deadline:
        time.sleep(0.01)
    return store.latest_step(d)


def test_failure_injection_and_recovery(tmp_path):
    """Crash mid-run, with the step-4 save possibly still in flight, and
    resume from the last checkpoint: the resumed run's final state equals
    an uninterrupted run's, bit for bit (batches are a pure function of
    the step)."""
    step = PS.make_train_step(CFG, opt.cosine_schedule(3e-3, 2, 10))
    d = str(tmp_path)
    with pytest.raises(PL._SimulatedFailure):
        PL.run_training(_state(), step, _spec(),
                        PL.LoopConfig(total_steps=10, ckpt_dir=d,
                                      ckpt_every=4, fail_at_step=6))
    resumed = _landed(d, 4)
    assert resumed == 4            # did not lose work beyond the interval
    out = PL.run_training(_state(), step, _spec(),
                          PL.LoopConfig(total_steps=10, ckpt_dir=d,
                                        ckpt_every=4))
    assert len(out["history"]) == 10 - resumed
    whole = PL.run_training(_state(), step, _spec(),
                            PL.LoopConfig(total_steps=10))
    assert _same(out["state"], whole["state"])


def test_straggler_watchdog_counts_slow_steps(monkeypatch):
    """After 5 steps, a step slower than ``watchdog_factor`` x the median
    of the last 50 is counted: a clock that moves 1 s a step and 10 s at
    the 8th flags exactly that one."""
    step = PS.make_train_step(CFG)
    clock = {"t": 0.0, "calls": 0}

    class _Clock:
        @staticmethod
        def perf_counter():
            return clock["t"]

    def slow_at_8(state, batch):
        clock["calls"] += 1
        clock["t"] += 10.0 if clock["calls"] == 8 else 1.0
        return step(state, batch)

    monkeypatch.setattr(PL, "time", _Clock)
    out = PL.run_training(_state(), slow_at_8, _spec(),
                          PL.LoopConfig(total_steps=10, watchdog_factor=3.0))
    assert out["stragglers_flagged"] == 1
    assert out["median_step_s"] == 1.0


def test_repro_checkpoint_resumes_in_the_port(tmp_path):
    """``repro``'s ``run_training`` writes TrainState checkpoints (async
    at step 2, final at 4); the port's resumes from step 4 with ``repro``'s
    state bit for bit and runs the remaining steps."""
    rcfg = LC.cfgs("tinyllama-1.1b")[0]
    p = LC.train_params_np("tinyllama-1.1b")
    rstate = RS.TrainState(params=jax.tree_util.tree_map(jax.numpy.asarray,
                                                         p),
                           opt_state=ropt.adamw_init(p),
                           step=jax.numpy.zeros((), jax.numpy.int32))
    d = str(tmp_path)
    rspec = RP.LMBatchSpec(vocab_size=256, seq_len=32, global_batch=2)
    rout = RL.run_training(rstate, jax.jit(RS.make_train_step(rcfg)), rspec,
                           RL.LoopConfig(total_steps=4, ckpt_dir=d,
                                         ckpt_every=2))
    assert rstore.latest_step(d) == 4
    template = _tree.tree_map(lambda a: a, _state())
    restored, st = store.restore(d, template, device="cpu")
    assert st == 4 and isinstance(restored, PS.TrainState)
    want = jax.tree_util.tree_leaves(rout["state"])
    got = _tree.flatten(restored)[0]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    out = PL.run_training(template, PS.make_train_step(CFG),
                          PP.LMBatchSpec(vocab_size=256, seq_len=32,
                                         global_batch=2),
                          PL.LoopConfig(total_steps=6, ckpt_dir=d,
                                        ckpt_every=2))
    assert len(out["history"]) == 2 and int(out["state"].step) == 6
    # and the port's checkpoint restores in repro
    back, rst = rstore.restore(d, rout["state"])
    assert rst == 6
    for g, w in zip(_tree.flatten(out["state"])[0],
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_cli.main(argv)
    return buf.getvalue().strip().splitlines()


def test_launcher_smoke_bfp_compressed():
    lines = _cli(["--arch", "tinyllama-1.1b", "--scale", "smoke", "--steps",
                  "4", "--batch", "4", "--seq", "64", "--bfp",
                  "--compress-grads", "--device", "cpu"])
    assert lines[0].startswith("step 0 loss ")
    assert lines[-1].startswith("done: loss ") and "median step" in lines[-1]


def test_launcher_moe_with_checkpoints(tmp_path):
    d = str(tmp_path / "ck")
    lines = _cli(["--arch", "olmoe-1b-7b", "--scale", "smoke", "--steps",
                  "4", "--batch", "4", "--seq", "64", "--ckpt-dir", d,
                  "--ckpt-every", "2", "--schedule", "wsd", "--device",
                  "cpu"])
    assert lines[-1].startswith("done: loss ")
    assert store.latest_step(d) == 4
