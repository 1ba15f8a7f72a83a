"""Sparsity-dependent model selection: the model zoo as an algorithm picker.

The port of ``repro.distributed.select``.  The paper's seven hypergraph
models are seven SpGEMM algorithms; which one communicates least depends on
the sparsity structure of the instance.  ``sweep_instance`` partitions
*every* model of an instance, records each one's predicted communication
(the connectivity metric, ``comm.evaluate``), lowers the partition to an
``ExecutionPlan`` whose routing tables are built by an independent code
path (transfer enumeration, ``plan_ir``), counts the words those tables
ship (``measured_route_words``), and optionally runs the executors against
the dense oracle.  ``Loopback`` stacks all p ranks on one device, so any p
runs wherever the executor's device is.

Everything model-specific (which models lower, how routed words are
weighted) comes from the declarative ``registry.ModelSpec`` table — this
module contains no per-model dispatch.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.partition import partition
from repro_torch.core.spgemm_models import MODELS, SpGEMMInstance
from repro_torch.distributed.plan_ir import ExecutionPlan, build_volume_plan
from repro_torch.distributed.registry import get_spec


def build_executable_plan(
    inst: SpGEMMInstance, model: str, parts: np.ndarray, p: int
) -> ExecutionPlan:
    """Lower a model partition to its executable plan: a registry lookup of
    the model's lowerer (pin-derived ownership, so each cut net of
    connectivity lambda costs exactly lambda - 1 shipped items)."""
    return get_spec(model).lower(inst, np.asarray(parts, dtype=np.int64), p)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _execute(handle, a_dense: np.ndarray, b_dense: np.ndarray, want: np.ndarray,
             device) -> dict:
    """Run a planned pipeline's executor on ``device`` and report wall time
    and max error against the dense oracle ``want`` (computed once per
    instance by the caller).  ``exec_s`` is the cold cost (structure work,
    uploads and the first call), ``exec_warm_us`` the steady-state per-call
    time of the raw runtime executor (rank-major shards out, no unpack)."""
    inst = handle.instance
    a_vals = a_dense[inst.a.coo()]
    b_vals = b_dense[inst.b.coo()]
    t0 = time.time()
    exe = handle.compile(device=device, dtype=np.promote_types(a_vals.dtype, b_vals.dtype))
    got = exe(a_vals, b_vals)
    _sync(exe.device)
    cold_s = time.time() - t0
    a_packed, b_packed = exe.pack(a_vals, b_vals)
    reps = 3
    t0 = time.time()
    for _ in range(reps):
        exe.runtime(a_packed, b_packed)
    _sync(exe.device)
    warm_us = (time.time() - t0) / reps * 1e6
    return {
        "exec_s": round(cold_s, 3),
        "exec_warm_us": int(warm_us),
        "exec_max_err": float(np.abs(got.cpu().numpy() - want).max()),
    }


def sweep_instance(
    inst: SpGEMMInstance,
    p: int,
    eps: float = 0.10,
    seed: int = 0,
    models: tuple[str, ...] = MODELS,
    a_dense: np.ndarray | None = None,
    b_dense: np.ndarray | None = None,
    execute: bool = False,
    pin_cap: int | None = None,
    device=None,
) -> list[dict]:
    """Partition every model, plan and (optionally) execute, and report
    predicted vs planned vs measured words per model.

    Returns one record per model, the same as ``repro``'s sweep but for
    timings; the minimum ``predicted_words`` row is the selected algorithm
    for this instance.  ``execute`` (with ``a_dense`` / ``b_dense``) also
    runs each executor on ``device`` — the card unless it names another.
    """
    from repro_torch.api import PlannedSpGEMM

    records = []
    run = execute and a_dense is not None
    # the oracle matmul is only worth materializing when executors will run
    want = a_dense @ b_dense if run else None
    for model in models:
        spec = get_spec(model)
        t0 = time.time()
        hg = spec.build(inst)
        if pin_cap is not None and hg.n_pins > pin_cap:
            records.append(
                {
                    "name": f"{inst.name}/select/{model}/p{p}",
                    "model": model,
                    "status": "skipped",
                    "reason": f"pins {hg.n_pins} > cap {pin_cap}",
                }
            )
            continue
        res = partition(hg, p, eps=eps, seed=seed)
        handle = PlannedSpGEMM(
            instance=inst,
            model=model,
            hypergraph=hg,
            partition=res,
            execution_plan=build_executable_plan(inst, model, res.parts, p),
            eps=eps,
            seed=seed,
        )
        report = handle.cost_report()
        vol_plan = build_volume_plan(hg, res.parts, p)
        rec = {
            "name": f"{inst.name}/select/{model}/p{p}",
            "model": model,
            "status": "ok",
            "us_per_call": int((time.time() - t0) * 1e6),
            "n_vertices": report["n_vertices"],
            "n_pins": report["n_pins"],
            "predicted_words": report["predicted_words"],
            "predicted_max_part": report["predicted_max_part"],
            "volume_plan_words": vol_plan.comm_words_ideal,
            "comp_imbalance": report["comp_imbalance"],
            "executable": True,
            "padded_words": report["padded_words"],
            "planned_messages": report["planned_messages"],
            # sweep-historical names: measured_* == the report's planned_*
            "measured_words": report["planned_words"],
        }
        assert rec["volume_plan_words"] == rec["predicted_words"], (
            f"{model}: volume plan diverged from connectivity metric"
        )
        if "planned_items" in report:
            # the unit count is the number of item transfers (e.g. row
            # shipments); the weighted count above is the useful words
            rec["measured_items"] = report["planned_items"]
        if run:
            rec.update(_execute(handle, a_dense, b_dense, want, device))
        records.append(rec)
    ok = [r for r in records if r["status"] == "ok"]
    if ok:
        best = min(ok, key=lambda r: r["predicted_words"])
        for r in records:
            r["selected"] = r is best
    return records
