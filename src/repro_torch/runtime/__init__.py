"""Fault-tolerant training loop (port of ``repro.runtime``).

* **Checkpoint/restart**: atomic checkpoints every ``ckpt_every`` steps;
  ``TrainLoop.run`` always resumes from the newest complete checkpoint, so a
  killed process loses at most one interval of work.
* **Straggler mitigation**: per-step wall time is tracked against a rolling
  median; a step slower than ``straggler_factor`` x the median fires the
  ``on_straggler`` hook, and ``max_step_time`` retries a step attempt that
  overran (the host-level guard against a hung collective).
* **Failure injection**: ``fail_after_steps`` simulates a node crash, used by
  the tests to prove loss-free resume.

PyTorch runs eagerly and returns before the card has finished, so every
attempt ends in a synchronise of the state's device (the reference's
``jax.block_until_ready``): without it a step's time would be the time to
queue its launches, and the straggler and retry guards would read nothing.

``run(state, shardings)`` resumes onto a mesh: ``shardings`` (a tree of
``NamedSharding``s matching the state) restores each leaf as this rank's
block, and the loop's checkpoints gather the blocks and are written by rank
0 (``repro_torch.checkpoint``). Every rank runs the loop.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Callable

import torch

from repro_torch import checkpoint as ckpt_lib
from repro_torch import tree


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_dir: str
    ckpt_every: int = 50
    keep_ckpts: int = 3
    straggler_factor: float = 3.0
    straggler_warmup: int = 8
    max_step_time: float | None = None     # seconds; None = no retry guard
    max_retries: int = 2
    log_every: int = 10


class StepFailure(RuntimeError):
    pass


def block_until_ready(state):
    """Wait for the device work that produces ``state``: a synchronise of
    the card its first CUDA tensor lies on (nothing for CPU tensors)."""
    for leaf in tree.leaves(state):
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
            torch.cuda.synchronize(leaf.device)
            break
    return state


@dataclasses.dataclass
class TrainLoop:
    """Drives ``state = step_fn(state, batch)`` with fault tolerance."""

    cfg: LoopConfig
    step_fn: Callable[[Any, Any], Any]       # returns the new state
    batch_fn: Callable[[int], Any]           # step -> batch (data pipeline)
    metrics_fn: Callable[[Any], dict] | None = None
    on_straggler: Callable[[int, float, float], None] | None = None
    # test hooks
    fail_after_steps: int | None = None
    clock: Callable[[], float] = time.monotonic

    def run(self, state, shardings=None):
        cfg = self.cfg
        start = 0
        last = ckpt_lib.latest_step(cfg.ckpt_dir)
        if last is not None:
            state = ckpt_lib.restore(cfg.ckpt_dir, last, state, shardings)
            start = last
        durations: list[float] = []
        executed = 0
        for step in range(start, cfg.total_steps):
            batch = self.batch_fn(step)
            t0 = self.clock()
            state = self._attempt(state, batch)
            dt = self.clock() - t0
            self._straggler_check(step, dt, durations)
            durations.append(dt)
            executed += 1
            if (step + 1) % cfg.ckpt_every == 0 or step + 1 == cfg.total_steps:
                ckpt_lib.save(cfg.ckpt_dir, step + 1, state,
                              shardings=shardings)
                if shardings is None or torch.distributed.get_rank() == 0:
                    ckpt_lib.gc_old(cfg.ckpt_dir, cfg.keep_ckpts)
            if self.fail_after_steps is not None \
                    and executed >= self.fail_after_steps:
                raise StepFailure(f"injected failure at step {step + 1}")
        return state

    def _attempt(self, state, batch):
        cfg = self.cfg
        for retry in range(cfg.max_retries + 1):
            t0 = self.clock()
            new_state = block_until_ready(self.step_fn(state, batch))
            if cfg.max_step_time is None \
                    or self.clock() - t0 <= cfg.max_step_time \
                    or retry == cfg.max_retries:
                return new_state
        raise StepFailure("unreachable")

    def _straggler_check(self, step, dt, durations):
        cfg = self.cfg
        if len(durations) >= cfg.straggler_warmup:
            med = statistics.median(durations[-64:])
            if dt > cfg.straggler_factor * med and self.on_straggler:
                self.on_straggler(step, dt, med)
