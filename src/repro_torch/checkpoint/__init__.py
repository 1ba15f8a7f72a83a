"""The persistent plan store (``checkpoint/store.py``)."""
from repro_torch.checkpoint.store import (
    PLAN_STORE_VERSION,
    PlanStoreError,
    RestoredPlan,
    list_plans,
    quarantine_plan,
    restore_plan,
    save_plan,
)

__all__ = [
    "PLAN_STORE_VERSION",
    "PlanStoreError",
    "RestoredPlan",
    "list_plans",
    "quarantine_plan",
    "restore_plan",
    "save_plan",
]
