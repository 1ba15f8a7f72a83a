"""Fault-injection harness: scripted failures at named stage boundaries.

A copy of ``repro.testing.faults`` (the port imports nothing of the JAX
package); the port fires the same stages at the same boundaries.

The resilient-session claim ("an iterated SpGEMM loop survives a failure at
any stage boundary") is only testable if failures can be *produced* at every
boundary, deterministically, without reaching into implementation details.
This module gives production code named patch points:

    from repro_torch.testing import faults
    ...
    faults.fire("partition")     # first line of core.partition.partition

and tests (or a scripted benchmark schedule) arm them:

    with faults.inject("partition", times=1):
        session.multiply(A, B)   # first partition call raises InjectedFault

When nothing is armed, ``fire`` is a dict lookup + counter increment — cheap
enough to live on planning hot paths.  Stages are just strings; the ones the
library fires today are in ``STAGES``.  Every injected failure is counted on
the script object, so tests can assert "the fault actually fired" instead of
passing vacuously when a code path moves.

``inject`` raises ``InjectedFault`` by default — a ``RetryableError``
subclass, so the session's ``FaultPolicy`` treats it as transient (the
common case: exercising retry/restart).  Pass ``exc=ValueError`` (or any
factory) to model a *permanent* failure and exercise the downgrade chain
instead.
"""
from __future__ import annotations

import contextlib

from repro_torch.resilience import RetryableError

__all__ = [
    "STAGES",
    "InjectedFault",
    "call_counts",
    "fire",
    "inject",
    "reset_counts",
    "scripted",
]

#: boundaries the library fires today (any string is accepted)
STAGES = ("partition", "compile", "execute", "store_save", "store_restore")


class InjectedFault(RetryableError):
    """A scripted failure from the fault-injection harness (transient)."""


class _Script:
    """One armed injection: counts the calls it sees, fails the scripted
    ones.  ``seen``/``fired`` are public so tests can assert the fault
    actually triggered."""

    def __init__(self, stage, exc, message, times, after, on_calls):
        self.stage = stage
        self.exc = exc
        self.message = message or f"injected {stage} fault"
        self.times = times
        self.after = after
        self.on_calls = None if on_calls is None else set(int(i) for i in on_calls)
        self.seen = 0
        self.fired = 0

    def check(self) -> None:
        i = self.seen
        self.seen += 1
        if self.on_calls is not None:
            hit = i in self.on_calls
        else:
            hit = i >= self.after and self.fired < self.times
        if hit:
            self.fired += 1
            raise self.exc(f"{self.message} (call {i} of stage {self.stage!r})")


_ACTIVE: dict[str, list[_Script]] = {}
_CALLS: dict[str, int] = {}


def fire(stage: str) -> None:
    """Patch point.  Called by production code at a stage boundary; raises
    when a script armed via :func:`inject` says this call should fail."""
    _CALLS[stage] = _CALLS.get(stage, 0) + 1
    scripts = _ACTIVE.get(stage)
    if not scripts:
        return
    for script in tuple(scripts):
        script.check()


@contextlib.contextmanager
def inject(
    stage: str,
    exc=InjectedFault,
    message: str | None = None,
    times: int = 1,
    after: int = 0,
    on_calls=None,
):
    """Arm ``stage`` to fail while the context is active.

    ``times``/``after``: fail the next ``times`` calls after skipping
    ``after`` of them.  ``on_calls``: explicit 0-based call indices (relative
    to entering the context) to fail instead — a scripted schedule.  Yields
    the script object (``.seen`` / ``.fired`` counters).
    """
    script = _Script(stage, exc, message, times, after, on_calls)
    _ACTIVE.setdefault(stage, []).append(script)
    try:
        yield script
    finally:
        _ACTIVE[stage].remove(script)
        if not _ACTIVE[stage]:
            del _ACTIVE[stage]


@contextlib.contextmanager
def scripted(schedule: dict):
    """Arm several stages at once: ``{stage: on_calls iterable}``.  Yields
    ``{stage: script}`` — the benchmark's failure-schedule entry point."""
    with contextlib.ExitStack() as stack:
        yield {
            stage: stack.enter_context(inject(stage, on_calls=calls))
            for stage, calls in schedule.items()
        }


def call_counts() -> dict:
    """Calls seen per stage since the last :func:`reset_counts` (counts
    accumulate whether or not anything is armed)."""
    return dict(_CALLS)


def reset_counts() -> None:
    _CALLS.clear()
