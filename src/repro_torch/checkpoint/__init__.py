"""Step checkpoints and the persistent plan store (``checkpoint/store.py``)."""
from repro_torch.checkpoint.store import (
    PLAN_STORE_VERSION,
    PlanStoreError,
    RestoredPlan,
    latest_step,
    list_plans,
    quarantine_plan,
    restore_checkpoint,
    restore_plan,
    save_checkpoint,
    save_plan,
)

__all__ = [
    "PLAN_STORE_VERSION",
    "PlanStoreError",
    "RestoredPlan",
    "latest_step",
    "list_plans",
    "quarantine_plan",
    "restore_checkpoint",
    "restore_plan",
    "save_checkpoint",
    "save_plan",
]
