"""Failure classification + retry/downgrade policy.

A copy of ``repro.resilience`` (the port imports nothing of the JAX
package), with the same classification.  One place answers "is this
exception worth retrying?" for every layer that restarts work — the
resilient session (``distributed/session.py``), the serving loop
(``launch/serve.py``) and the fault-injection harness
(``repro_torch.testing.faults``): an explicit predicate plus a declarative
``FaultPolicy`` (retries, backoff, downgrade chains) the session threads
through every stage.

PyTorch's ``torch.cuda.OutOfMemoryError`` ("CUDA out of memory") carries
the ``"out of memory"`` marker and is retried; a sticky CUDA launch error
("an illegal memory access was encountered") carries none and is
permanent.  XLA's ``XlaRuntimeError`` stays recognized by type *name*, as
in the reference, so a plan or fault raised by either package classifies
the same.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

__all__ = [
    "FaultPolicy",
    "RetryableError",
    "is_retryable",
    "retry_call",
]


class RetryableError(RuntimeError):
    """Transient by construction — simulated node loss, injected faults,
    and any library error explicitly raised as worth-retrying."""


# transient-resource markers XLA / distributed runtimes put in messages
_RETRYABLE_MARKERS = (
    "RESOURCE_EXHAUSTED",
    "DEADLINE_EXCEEDED",
    "UNAVAILABLE",
    "out of memory",
)
# exception type names (matched without importing their home modules)
_RETRYABLE_TYPE_NAMES = ("XlaRuntimeError",)
# OSError subclasses that are *state*, not transience: retrying a missing
# path or a permission wall burns the retry budget for nothing
_PERMANENT_OS_ERRORS = (
    FileNotFoundError,
    IsADirectoryError,
    NotADirectoryError,
    PermissionError,
)


def is_retryable(exc: BaseException) -> bool:
    """Explicit retryable-exception predicate.

    Retryable: ``RetryableError`` (incl. injected faults), memory pressure
    (``MemoryError``, or a runtime error carrying a transient-resource
    marker such as CUDA's "out of memory"), timeouts,
    connection blips, and transient filesystem errors.  Everything else —
    shape mismatches, missing files, plain ``ValueError`` bugs — is
    permanent and must surface immediately.
    """
    if isinstance(exc, RetryableError):
        return True
    if isinstance(exc, (MemoryError, TimeoutError, ConnectionError)):
        return True
    if isinstance(exc, OSError):
        return not isinstance(exc, _PERMANENT_OS_ERRORS)
    name = type(exc).__name__
    if name in _RETRYABLE_TYPE_NAMES or isinstance(exc, RuntimeError):
        msg = str(exc)
        return any(marker in msg for marker in _RETRYABLE_MARKERS)
    return False


@dataclasses.dataclass(frozen=True)
class FaultPolicy:
    """How a resilient caller reacts to a failing stage.

    - ``max_retries`` / ``backoff_s`` / ``backoff_factor``: transient
      failures (per :func:`is_retryable`, overridable via ``retryable``)
      are retried up to ``max_retries`` times with exponential backoff.
    - ``engine_chain``: partitioner downgrade order — a failing
      ``engine="device"`` plan falls back to the host ``"flat"`` engine.
    - ``model_chain``: executor downgrade order — a model whose
      compile/execute keeps failing (e.g. fine's 3-route program OOMs) is
      replanned with the next cheaper-to-run model in the chain.
    """

    max_retries: int = 2
    backoff_s: float = 0.02
    backoff_factor: float = 2.0
    engine_chain: tuple[str, ...] = ("device", "flat")
    model_chain: tuple[str, ...] = ("fine", "monoC", "rowwise")
    retryable: Callable[[BaseException], bool] = is_retryable

    def delays(self, n: int | None = None):
        """Backoff delays (seconds) for retry 1, 2, ... — exponential."""
        n = self.max_retries if n is None else n
        d = self.backoff_s
        for _ in range(n):
            yield d
            d *= self.backoff_factor

    def downgrades(self, current: str, chain: tuple[str, ...]) -> list[str]:
        """Fallbacks to try after ``current``, in chain order.  A ``current``
        not in the chain downgrades to the whole chain."""
        if current in chain:
            return list(chain[chain.index(current) + 1 :])
        return [c for c in chain if c != current]


def retry_call(
    fn: Callable,
    policy: FaultPolicy,
    *,
    stage: str = "",
    on_retry: Callable | None = None,
    sleep: Callable = time.sleep,
):
    """Call ``fn()`` with the policy's retry budget.

    Retries only exceptions ``policy.retryable`` accepts; sleeps the
    policy's backoff between attempts; re-raises the final failure.
    ``on_retry(stage, attempt_index, exc)`` observes each retry (the
    session turns these into events).
    """
    delays = policy.delays()
    for attempt in range(policy.max_retries + 1):
        try:
            return fn()
        except Exception as exc:
            if attempt >= policy.max_retries or not policy.retryable(exc):
                raise
            if on_retry is not None:
                on_retry(stage, attempt, exc)
            delay = next(delays)
            if delay > 0:
                sleep(delay)
