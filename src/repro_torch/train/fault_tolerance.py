"""Fault tolerance: checkpoint/restart train loop, straggler watchdog,
failure injection, restore onto a device.

The port of ``repro.train.fault_tolerance``, with the same invariants:

* every step is DETERMINISTIC in (seed, step) — the loader is stateless,
  so a restart at step k replays exactly the batches k, k+1, ... with no
  data loss or duplication;
* checkpoints are atomic + keep-k (``repro_torch.train.checkpoint``),
  written async off the critical path;
* a crash (injected or real, any ``RuntimeError``: CUDA errors are
  ones) triggers restore-latest + replay;
* per-step wall times feed a straggler watchdog (median × factor rule;
  it records events for tests and benchmarks);
* ``elastic_restore`` restores the latest checkpoint onto a device; the
  reference's remesh onto another sharding tree waits for ROADMAP item
  M12d.

The state is restored into the structure, dtypes and device of the
state the loop was given, read off a storage-less skeleton of it
(``checkpoint.skeleton``; the reference takes a host copy), so the loop
keeps no second copy of the state alive.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.device import DeviceLike
from repro_torch.train import checkpoint as ckpt_lib


@dataclasses.dataclass
class StragglerEvent:
    step: int
    step_time: float
    median: float


class StepWatchdog:
    """Flags steps slower than ``factor`` x running median."""

    def __init__(self, factor: float = 2.0, window: int = 50):
        self.factor = factor
        self.window = window
        self.times: List[float] = []
        self.events: List[StragglerEvent] = []

    def observe(self, step: int, dt: float) -> Optional[StragglerEvent]:
        self.times.append(dt)
        hist = self.times[-self.window :]
        med = float(np.median(hist))
        if len(hist) >= 5 and dt > self.factor * med:
            ev = StragglerEvent(step=step, step_time=dt, median=med)
            self.events.append(ev)
            return ev
        return None


@dataclasses.dataclass
class RunReport:
    steps_run: int
    restarts: int
    final_step: int
    losses: List[float]
    straggler_events: List[StragglerEvent]


def run_training(
    step_fn: Callable,
    state,
    batch_fn: Callable[[int], Dict],
    num_steps: int,
    ckpt_dir: str,
    ckpt_every: int = 10,
    keep: int = 3,
    fail_at: Optional[Callable[[int], bool]] = None,
    max_restarts: int = 5,
    watchdog: Optional[StepWatchdog] = None,
    async_ckpt: bool = True,
) -> RunReport:
    """Fault-tolerant loop.  ``fail_at(step)`` injects a crash (tests);
    recovery = restore latest checkpoint and REPLAY from there, exactly
    as a real preemption restart would."""
    watchdog = watchdog or StepWatchdog()
    saver = ckpt_lib.AsyncCheckpointer(ckpt_dir, keep=keep) if async_ckpt else None
    like, device = ckpt_lib.skeleton(state)

    losses: List[float] = []
    restarts = 0
    step = 0
    start_step, restored = ckpt_lib.restore_latest(ckpt_dir, like, device)
    if restored is not None:
        state = restored
        step = start_step

    while step < num_steps:
        try:
            if fail_at is not None and fail_at(step):
                raise RuntimeError(f"injected failure at step {step}")
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch_fn(step))
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            watchdog.observe(step, dt)
            losses.append(loss)
            step += 1
            if step % ckpt_every == 0:
                if saver is not None:
                    saver.save(step, state)
                else:
                    ckpt_lib.save_checkpoint(ckpt_dir, step, state, keep=keep)
        except RuntimeError:
            restarts += 1
            if restarts > max_restarts:
                raise
            if saver is not None:
                saver.wait()
            prev_step, restored = ckpt_lib.restore_latest(ckpt_dir, like, device)
            if restored is None:
                step = 0  # nothing durable yet: restart from scratch
            else:
                state, step = restored, prev_step
    if saver is not None:
        saver.save(step, state)
        saver.wait()
    return RunReport(
        steps_run=len(losses),
        restarts=restarts,
        final_step=step,
        losses=losses,
        straggler_events=watchdog.events,
    )


def elastic_restore(ckpt_dir: str, like, device: DeviceLike = None):
    """Restore the latest checkpoint onto ``device`` (each leaf on its
    ``like`` leaf's device when None).  Returns ``(step, state)``."""
    return ckpt_lib.restore_latest(ckpt_dir, like, device=device)
