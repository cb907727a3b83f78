"""Fault-tolerant training loop (counterpart of ``repro.train.loop``).

  * checkpoint/restore with atomic steps + checksum validation
    (``checkpoint.store``), resuming from the latest valid step after
    any crash;
  * straggler watchdog: counts steps slower than ``watchdog_factor`` x
    the median of the last 50 (after 5 steps);
  * failure injection for tests (``fail_at_step`` raises mid-run exactly
    once, proving the resume path);
  * deterministic data: batch = f(seed, step) (``data.pipeline
    .lm_batch``), so restarts neither replay nor skip data.

Batches are made on the state's device; each step waits for its loss
(``torch.cuda.synchronize`` on the card) before it is timed.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import store
from repro_torch.data.pipeline import LMBatchSpec, lm_batch
from repro_torch.train.step import TrainState

__all__ = ["LoopConfig", "run_training"]


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 25
    keep: int = 3
    watchdog_factor: float = 3.0
    fail_at_step: Optional[int] = None     # failure injection (tests)
    log_every: int = 10


class _SimulatedFailure(RuntimeError):
    pass


def _wait(t: torch.Tensor) -> None:
    """``jax.block_until_ready``: the device's queue up to ``t``."""
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def run_training(
    state: TrainState,
    train_step: Callable,
    batch_spec: LMBatchSpec,
    loop: LoopConfig,
    log_fn: Callable[[int, Dict[str, float]], None] = None,
) -> Dict[str, Any]:
    """Run (or resume) training.  Returns summary dict with history."""
    dev = state.step.device
    ckpt = store.Checkpointer(loop.ckpt_dir, loop.keep) \
        if loop.ckpt_dir else None
    start = 0
    if loop.ckpt_dir:
        restored, step = store.restore(loop.ckpt_dir, state, device=dev)
        if restored is not None:
            state, start = restored, int(step)

    history: List[Dict[str, float]] = []
    step_times: List[float] = []
    stragglers = 0

    for step in range(start, loop.total_steps):
        t0 = time.perf_counter()
        if loop.fail_at_step is not None and step == loop.fail_at_step:
            raise _SimulatedFailure(f"injected failure at step {step}")
        batch = lm_batch(batch_spec, step, device=dev)
        state, metrics = train_step(state, batch)
        _wait(metrics["loss"])
        dt = time.perf_counter() - t0
        # --- straggler watchdog --------------------------------------------
        if len(step_times) >= 5:
            med = float(np.median(step_times[-50:]))
            if dt > loop.watchdog_factor * med:
                stragglers += 1
        step_times.append(dt)
        m = {k: float(v) for k, v in metrics.items()}
        history.append(m)
        if log_fn and step % loop.log_every == 0:
            log_fn(step, m)
        if ckpt and (step + 1) % loop.ckpt_every == 0:
            ckpt.save_async(step + 1, state)
    if ckpt:
        ckpt.wait()
        store.save(loop.ckpt_dir, loop.total_steps, state, loop.keep)
    return {"state": state, "history": history,
            "stragglers_flagged": stragglers,
            "median_step_s": float(np.median(step_times)) if step_times
            else 0.0}
