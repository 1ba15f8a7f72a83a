"""Fault tolerance + straggler mitigation around the step loop (a copy of
``repro.launch.elastic``: pure Python on ``repro_torch.checkpoint`` and
``repro_torch.resilience``).

Each restart resumes from the latest atomic checkpoint; the checkpoint
layout is device-agnostic (``repro_torch.checkpoint``), so the restarted
job may come up on another card, or on the host.  In-process, failures are
injected into the step loop and the loop restarts itself.

Straggler mitigation: per-step wall-time watchdog; a step exceeding
``straggler_factor`` x the running median is recorded and (at scale) would
trigger the slot-exclusion path — here it is surfaced in the stats so
tests can assert on detection.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.resilience import RetryableError, is_retryable


@dataclasses.dataclass
class RunStats:
    steps_run: int = 0
    restarts: int = 0
    stragglers: list = dataclasses.field(default_factory=list)
    step_times: list = dataclasses.field(default_factory=list)


class InjectedFailure(RetryableError):
    """Simulated node failure (tests)."""


def run_loop(
    state,
    step_fn: Callable,  # (state, step_idx) -> state
    n_steps: int,
    ckpt_dir: str | None = None,
    ckpt_every: int = 10,
    max_restarts: int = 3,
    failure_injector: Callable[[int], None] | None = None,
    straggler_factor: float = 3.0,
    state_to_tree: Callable = lambda s: s,
    tree_to_state: Callable = lambda t, s: t,
    retryable: Callable[[BaseException], bool] = is_retryable,
    restart_backoff_s: float = 0.0,
    restart_backoff_factor: float = 2.0,
    sleep: Callable = time.sleep,
    save: Callable = save_checkpoint,
) -> tuple[object, RunStats]:
    """Checkpointed, restartable step loop.

    Restarts only on ``retryable`` failures (``resilience.is_retryable`` by
    default — the predicate ``FaultPolicy`` shares, replacing the old
    ``"RESOURCE_EXHAUSTED"`` substring match), waiting ``restart_backoff_s``
    (doubled per consecutive restart) before each restart so a crash-looping
    resource isn't hammered.  ``save(ckpt_dir, step, tree)`` writes a
    checkpoint (``save_checkpoint``; over several processes, rank 0 writes
    and the others pass a no-op, each still calling ``state_to_tree``,
    which may gather the state)."""
    stats = RunStats()
    start = 0
    if ckpt_dir is not None and latest_step(ckpt_dir) is not None:
        tree, start = restore_checkpoint(ckpt_dir)
        state = tree_to_state(tree, state)
    step = start
    restarts = 0
    backoff = restart_backoff_s
    while step < n_steps:
        try:
            t0 = time.monotonic()
            if failure_injector is not None:
                failure_injector(step)
            state = step_fn(state, step)
            dt = time.monotonic() - t0
            stats.step_times.append(dt)
            med = sorted(stats.step_times)[len(stats.step_times) // 2]
            if len(stats.step_times) >= 5 and dt > straggler_factor * med:
                stats.stragglers.append((step, dt, med))
            step += 1
            stats.steps_run += 1
            backoff = restart_backoff_s  # a completed step resets the backoff
            if ckpt_dir is not None and (
                step % ckpt_every == 0 or step == n_steps
            ):
                save(ckpt_dir, step, state_to_tree(state))
        except Exception as e:
            if not retryable(e):
                raise
            restarts += 1
            stats.restarts = restarts
            if restarts > max_restarts:
                raise
            if ckpt_dir is None:
                raise
            if backoff > 0:
                sleep(backoff)
                backoff *= restart_backoff_factor
            if latest_step(ckpt_dir) is not None:
                tree, step = restore_checkpoint(ckpt_dir)
                state = tree_to_state(tree, state)
            else:
                step = 0
    return state, stats
