"""Distributed SpGEMM: plan IR, collectives, executors, model registry and
the compile-once runtime (the port of ``repro.distributed``).

The public surface is ``__all__``, the reference's; attributes resolve
lazily (PEP 562), so importing a planning module loads no executor.
"""
from __future__ import annotations

import importlib

_HOME = {
    "repro_torch.distributed.plan_ir": (
        "ExecutionPlan",
        "FinePlan",
        "MonoCPlan",
        "OuterPlan",
        "Route",
        "RowwisePlan",
        "build_fine_plan",
        "build_monoC_plan",
        "build_outer_plan",
        "build_rowwise_plan",
        "build_volume_plan",
        "derive_owner_from_pins",
        "measured_route_words",
        "plan_fine_from_dense",
        "plan_monoC_from_dense",
    ),
    "repro_torch.distributed.registry": (
        "MODEL_SPECS",
        "ModelSpec",
        "executable_models",
        "get_spec",
    ),
    "repro_torch.distributed.runtime": ("CompiledSpGEMM", "compile_spgemm"),
    "repro_torch.distributed.summa": (
        "SummaPlan",
        "build_summa_plan",
        "summa_words_ideal",
    ),
    "repro_torch.distributed.session": ("SpGEMMSession",),
    "repro_torch.distributed.spgemm_exec": (
        "fine_spgemm",
        "monoC_spgemm",
        "outer_product_spgemm",
        "rowwise_spgemm",
        "spsumma",
    ),
}
_EXPORT_TO_MODULE = {name: mod for mod, names in _HOME.items() for name in names}
__all__ = sorted(_EXPORT_TO_MODULE)


_DEPRECATION_WARNED = False


def __getattr__(name: str):
    # deprecation shim (warn once), as the reference's: the loop reference is
    # not on the public surface, but the package-level name keeps working
    if name == "build_rowwise_plan_loop":
        global _DEPRECATION_WARNED
        if not _DEPRECATION_WARNED:
            import warnings

            warnings.warn(
                "repro_torch.distributed.build_rowwise_plan_loop is deprecated; "
                "import it from repro_torch.distributed.plan (it is a loop-based "
                "reference implementation, not a supported entry point)",
                DeprecationWarning,
                stacklevel=2,
            )
            _DEPRECATION_WARNED = True
        from repro_torch.distributed.plan import build_rowwise_plan_loop

        return build_rowwise_plan_loop
    module = _EXPORT_TO_MODULE.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(module), name)
    globals()[name] = value  # cache: later lookups skip __getattr__
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
