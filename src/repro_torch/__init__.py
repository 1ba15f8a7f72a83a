"""repro_torch — hypergraph-partitioned SpGEMM in PyTorch and CUDA.

The port of ``repro`` (the JAX package, which stays the reference) to an
NVIDIA Hopper card.  It imports ``torch`` and never ``jax``, and nothing of
``repro``: the numpy/scipy planning it needs is copied, and the tests pin
the copies to the reference's results.  The public surface is the
``repro_torch.api`` pipeline:

    import repro_torch

    spgemm = repro_torch.plan(A, B, p=4, model="auto")
    spgemm.cost_report()
    C = spgemm.compile()(a_vals, b_vals)      # dense C tensor on the card
    sess = repro_torch.session(p=4)           # warm pool, replans on drift
    C = sess.multiply(A, B)

Attributes resolve lazily (PEP 562), so ``import repro_torch`` loads
nothing heavy until a name is used.
"""
from __future__ import annotations

__all__ = [
    "MODELS",
    "MODEL_SPECS",
    "CompiledSpGEMM",
    "FaultPolicy",
    "ModelSpec",
    "PlannedSpGEMM",
    "SpGEMMInstance",
    "SpGEMMSession",
    "device_count",
    "executable_models",
    "plan",
    "session",
]

_FROM_API = ("plan", "session", "PlannedSpGEMM", "CompiledSpGEMM", "device_count")
_FROM_REGISTRY = ("ModelSpec", "MODEL_SPECS", "executable_models")
_FROM_CORE = ("MODELS", "SpGEMMInstance")
_FROM_RESILIENCE = ("FaultPolicy",)
_FROM_SESSION = ("SpGEMMSession",)


def __getattr__(name: str):
    if name in _FROM_API:
        from repro_torch import api

        return getattr(api, name)
    if name in _FROM_REGISTRY:
        from repro_torch.distributed import registry

        return getattr(registry, name)
    if name in _FROM_CORE:
        from repro_torch.core import spgemm_models

        return getattr(spgemm_models, name)
    if name in _FROM_RESILIENCE:
        from repro_torch import resilience

        return getattr(resilience, name)
    if name in _FROM_SESSION:
        from repro_torch.distributed import session

        return getattr(session, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
