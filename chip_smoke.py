#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

Run from the repository root, with no arguments:  python3 chip_smoke.py

Phases, each printing its seconds:
  1. the card (nvidia-smi name and power limit, torch's device name);
  2. build every CUDA source of the port with nvcc (``-Xptxas -v`` lines),
     and count the HGMMA (wgmma) instructions in the SASS of K3 and of K1:
     none in either fails;
  3. the BSR SpGEMM kernels against their plain PyTorch version on seeded
     random block matrices, b in {1, 8, 16, 32}, fp32 and bf16, plus a pair
     list with a trailing garbage run;
  4. the main path at block 1: ``repro_torch.plan(inst, p=4, model="monoC")``
     then ``.compile()`` on the card for the AMG n=42 Galerkin products
     27-AP and 27-PTAP, checked against scipy in float64; then the kernel
     timed on 27-AP's own kernel inputs against its plain version and
     against one CSR @ CSR call, and a profiler breakdown of one call;
  5. the tiled path at block 16: ``plan_monoC_from_dense`` on a seeded
     4096 x 4096 block-sparse operand, squared, checked against a float64
     dense product on the card (K1 ``warp_runs``);
  6. K1 at every block shape: (bm, bk, bn) in {(8, 16, 8), (16, 8, 32),
     (64, 64, 64), (128, 128, 128)}, fp32 and bf16, against its plain
     version; then ``repro_torch.kernels.ops.spgemm`` on the block-16
     operand retiled 32 x 32 (``tile_runs``) and 64 x 64 (``mma_runs``),
     squared, against a float64 dense product;
  7. K2 (``ops.spmm``): the AMG n=42 27-point operator tiled 8 x 8 by
     scipy, times a seeded (74,088, 256) dense block, in fp32
     (``warp_rows``) and bf16 (``mma_rows``, tensor cores), tiled 12 x 12
     in fp32 (``warp_blocks``) and bf16 (``mma_blocks``), and tiled 3 x 3
     in fp32 (``warp_blocks``), against scipy in float64 and against the
     plain version, with the bytes each gathers;
  8. K3 (``ops.grouped_gemm``): the up and down expert projections of
     Qwen3-MoE-235B-A22B (E = 128, C = 640, d = 4096, f = 1536) in bf16
     (``expert_wgmma``, tensor cores) and the up projection in fp32 on
     full-mantissa data (``split3_bf16`` then ``expert_split``, split
     products on the tensor cores), against the plain version, beside
     ``torch.bmm``, with what sets its error; a bf16 view of x off
     alignment at the same width, which must take ``stage16`` then
     ``expert_wgmma``, beside ``torch.bmm`` on the same view, and the
     stage alone bit for bit; then every route off its tile grid, d and f
     off a multiple of 8 in bf16, fp16, fp32 and mixed, views off
     alignment, and ``expert_split`` held to each of its six products;
  9. every model: the other six paper models (rowwise, columnwise, outer,
     fine, monoA, monoB) through the front door on 27-PTAP at n=42; all
     seven and ``model="auto"`` on LP-pds100 at scale 1, where auto's
     selection must be the seven cost reports with the minimum selected;
     rowwise, columnwise and outer on 27-AP at n=42, with a profiler
     breakdown of one rowwise and one outer call.  Each run: plan, compile,
     10 calls after a warm-up, the collective's items per call against the
     plan's, the peak memory, and the last call against scipy in float64;
 10. serving: monoC at p = 4 on LP-pds100 A A^T — 64 multiplies looped and
     as 8 dispatches of ``compile(batch=8)`` (one K1 launch each), then a
     ``SpGEMMServer`` with a plan store draining 48 interleaved requests
     (pool hits, a cold structure, a drifted one warm-replanned), a restart
     that restores from the store, and a scripted transient fault; every
     product against scipy in float64, no unscripted downgrade, fallback,
     retry or failure.
Then one JSON line of per-kernel numbers (one entry per __global__, each
with the launches of the path it is read on: ``scalar_runs`` on the block-1
path, ``warp_runs`` on the block-16 path, ``tile_runs`` and ``mma_runs``
on the retiled 32 and 64 products, ``warp_rows`` and ``mma_rows`` on the
fp32 and bf16 AMG SpMMs at 8 x 8, ``warp_blocks`` and ``mma_blocks`` on
the fp32 and bf16 ones at 12 x 12, ``expert_wgmma``
on the bf16 up projection, ``expert_split`` and ``split3_bf16`` on the
fp32 one, ``stage16`` on the misaligned bf16 up projection; bounds at the
peak of each route's arithmetic, ``PEAK_FLOPS``; a time under its bound
fails), the card line, and the result line; the phases' full records go to
``chip_smoke.json`` under ``OUT`` (phase 10 under ``serving``).
Any failure exits non-zero without the result line; there is no CPU
fallback.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT = ROOT / "chiprun_out"  # full per-phase records (chip_smoke.json)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# Peak operations a second (H100 SXM data sheet, dense), by what a route
# computes on: fp32 FMAs on the CUDA cores ("float32"); fp32-accurate
# products on the tensor cores ("float32_split": six bf16 products of three
# pieces at 989 TFLOP/s, the same time as three TF32 products at 494.7);
# bf16 and fp16 on the tensor cores.
PEAK_FLOPS = {"float32": 67e12, "float32_split": 989e12 / 6, "bfloat16": 989e12,
              "float16": 989e12}
TOL = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 2e-2}
P = 4
AMG_N = 42
WARMUP, REPS = 1, 10


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def phase(name: str, t0: float) -> None:
    print(f"[phase] {name}: {time.perf_counter() - t0:.2f} s", flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events over ``reps``."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def graph_ms(fn, reps: int = 20) -> float:
    """Device time (ms) per call of ``fn``: ``reps`` calls captured in one
    CUDA graph, replayed between two events.  Unlike events around
    back-to-back calls, this does not read the host's pace where a kernel
    is shorter than its wrapper's Python."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capturing stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    ms = cuda_ms(graph.replay, reps=3, warmup=1) / reps
    del graph
    return ms


def bound(n_bytes: float, ops: float, peak: str):
    """Least time (ms) for ``n_bytes`` of traffic and ``ops`` operations at
    ``PEAK_FLOPS[peak]`` on the card, and which of the two bounds it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_FLOPS[peak]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def k1_peak(a_tab, b_tab) -> str:
    """The peak K1's route for these blocks is held to: fp32 on mma_runs
    runs as split products on the tensor cores."""
    from repro_torch.kernels.bsr_spgemm import route

    name = dtype_name(a_tab.dtype)
    kernel = route(a_tab.shape[1], a_tab.shape[2], b_tab.shape[2])
    split = name == "float32" and kernel == "mma_runs"
    return "float32_split" if split else name


def kernel_bound(a_tab, b_tab, pa, pb, run_start, run_c):
    """Least time (ms) for K1's work and what bounds it.  Bytes: the
    A and B slots the pair list reads (each once), the four index arrays it
    reads, and one written C block per run, over the HBM rate.  Operations:
    the multiply-adds of this pair list over the peak of the route's
    arithmetic (``k1_peak``).  Table slots no pair reads (padding, unused
    receive slots) are not counted, nor are C slots no run writes.  Returns
    (ms, bound by, bytes, operations, peak)."""
    import torch

    es = a_tab.element_size()
    _, bm, bk = a_tab.shape
    bn = b_tab.shape[-1]
    n_bytes = (
        (torch.unique(pa).numel() * bm * bk + torch.unique(pb).numel() * bk * bn
         + run_c.numel() * bm * bn) * es
        + sum(t.numel() * t.element_size() for t in (pa, pb, run_start, run_c))
    )
    ops = 2.0 * pa.numel() * bm * bk * bn
    peak = k1_peak(a_tab, b_tab)
    return (*bound(n_bytes, ops, peak), n_bytes, ops, peak)


def random_block_case(rng, grid: int, shape, density: float, dtype, device):
    """Seeded random block matrices A, B (grid x grid blocks of (bm, bk) and
    (bk, bn) = ``shape``) and their pair lists, with a trailing run of
    padding pairs into a garbage C slot."""
    import torch
    from repro_torch.kernels.bsr_spgemm import build_pair_lists, pair_runs

    bm, bk, bn = shape

    def blocks(rows, cols):
        coords = np.argwhere(rng.random((grid, grid)) < density)
        vals = rng.standard_normal((len(coords) + 1, rows, cols)).astype(np.float32)
        vals[-1] = 0.0  # the all-zero slot padding pairs read
        return coords, vals

    (ac, av), (bc, bv) = blocks(bm, bk), blocks(bk, bn)
    pa, pb, pc, crows, _ = build_pair_lists(ac[:, 0], ac[:, 1], bc[:, 0], bc[:, 1])
    pad = 64
    pa = np.r_[pa, [len(av) - 1] * pad]
    pb = np.r_[pb, [len(bv) - 1] * pad]
    pc = np.r_[pc, [len(crows)] * pad]
    run_start, run_c = pair_runs(pc)
    t = lambda x: torch.as_tensor(np.asarray(x, np.int32), device=device)  # noqa: E731
    return (
        torch.from_numpy(av).to(device, dtype),
        torch.from_numpy(bv).to(device, dtype),
        t(pa), t(pb), t(pc), t(run_start), t(run_c),
        len(crows) + 1,
    )


def reset_launches() -> None:
    """Every kernel wrapper's launch counts to 0."""
    from repro_torch.kernels.bsr_spgemm import bsr_spgemm_local
    from repro_torch.kernels.bsr_spmm import bsr_spmm_local
    from repro_torch.kernels.moe_gemm import moe_gemm

    for counts in (bsr_spgemm_local.launches, bsr_spmm_local.launches, moe_gemm.launches):
        for kernel in counts:
            counts[kernel] = 0


def max_err_within(got, want, tol: float, what: str) -> float:
    """max |got - want|; fails unless every element is within tol + tol |want|."""
    err = (got.float() - want.float()).abs()
    if not bool((err <= tol + tol * want.float().abs()).all()):
        fail(f"{what}: max abs err {err.max().item()}")
    return float(err.max().item())


def check_kernel(args, tol: float, garbage_slot: bool = True):
    """K1 against the plain version on the same inputs; returns
    (max_abs_err, the kernel's ms by graph replay, the wrapper's call ms by
    events, plain ms).  With ``garbage_slot`` the last C slot is a padding run's and
    must stay zero."""
    import torch
    from repro_torch.kernels.bsr_spgemm import bsr_spgemm_local, launch
    from repro_torch.kernels.ref import bsr_spgemm_ref

    a, b, pa, pb, pc, rs, rc, n_c = args
    got = bsr_spgemm_local(*args)
    want = bsr_spgemm_ref(a, b, pa, pb, pc, n_c)
    torch.cuda.synchronize()
    err = max_err_within(got, want, tol, "K1 disagrees with its plain version")
    if garbage_slot and got[-1].any():
        fail("the garbage C slot is not zero")
    out = torch.zeros_like(got)
    ms = graph_ms(lambda: launch(a, b, pa, pb, rs, rc, out))
    call_ms = cuda_ms(lambda: bsr_spgemm_local(*args))
    plain_ms = cuda_ms(lambda: bsr_spgemm_ref(a, b, pa, pb, pc, n_c))
    return err, ms, call_ms, plain_ms


def scipy_csr(structure, values):
    import scipy.sparse as sp

    return sp.csr_matrix(
        (values.astype(np.float64), structure.indices, structure.indptr),
        shape=structure.shape,
    )


def check_product(inst, c, a_np, b_np, device, what: str) -> float:
    """``c`` (dense, on the card) against scipy in float64 at C's
    coordinates, within 1e-4 + 1e-4 |want|, with exact zeros elsewhere;
    returns the max abs error."""
    import torch

    a_s, b_s, c_s = inst.a, inst.b, inst.c
    want = (scipy_csr(a_s, a_np) @ scipy_csr(b_s, b_np)).tocsr()
    want.sum_duplicates()
    want.sort_indices()
    if not (np.array_equal(want.indptr, c_s.indptr) and np.array_equal(want.indices, c_s.indices)):
        fail(f"{what}: scipy's product structure differs from the planned C")
    crow, ccol = c_s.coo()
    rows, cols = torch.as_tensor(crow, device=device), torch.as_tensor(ccol, device=device)
    if tuple(c.shape) != c_s.shape or c.device.type != "cuda" or c.dtype != torch.float32:
        fail(f"{what}: result {tuple(c.shape)} {c.dtype} on {c.device}")
    got = c[rows, cols].double()
    ref = torch.from_numpy(want.data).to(device)
    err = (got - ref).abs()
    if not bool(torch.isfinite(c).all()) or not bool((err <= 1e-4 + 1e-4 * ref.abs()).all()):
        fail(f"{what}: wrong product, max abs err {err.max().item()}")
    if int(torch.count_nonzero(c)) != int(torch.count_nonzero(got)):
        fail(f"{what}: nonzeros outside C's structure")
    return float(err.max().item())


def front_door_run(inst, model, device, rng, handle=None):
    """Plan (unless ``handle`` is given), compile and run one model through
    the front door: 1 warm-up call, then ``REPS`` timed calls, each ending
    in a synchronize; the collective's items per call must equal the
    plan's (``moved_items``); the last call is checked against scipy in
    float64.  Returns (compiled handle, the last call's device values,
    record)."""
    import torch
    import repro_torch
    from repro_torch.distributed.plan_ir import moved_items
    from repro_torch.kernels.bsr_spgemm import bsr_spgemm_local

    plan_s = None
    if handle is None:
        t0 = time.perf_counter()
        handle = repro_torch.plan(inst, p=P, model=model, seed=0)
        plan_s = time.perf_counter() - t0
    report = handle.cost_report()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    exe = handle.compile()
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    a_s, b_s, c_s = inst.a, inst.b, inst.c
    values = [
        (rng.standard_normal(a_s.nnz).astype(np.float32),
         rng.standard_normal(b_s.nnz).astype(np.float32))
        for _ in range(WARMUP + REPS)
    ]
    dev_values = [(torch.from_numpy(a).to(device), torch.from_numpy(b).to(device))
                  for a, b in values]
    for a, b in dev_values[:WARMUP]:
        c = exe(a, b)
    del c
    torch.cuda.synchronize()
    reset_launches()
    comm = exe.runtime.comm
    comm.reset()
    times = []
    for a, b in dev_values[WARMUP:]:
        t0 = time.perf_counter()
        c = exe(a, b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    what = f"{inst.name} {handle.model}"
    items = moved_items(handle.execution_plan)
    if comm.items_moved != REPS * items:
        fail(f"{what}: the collective moved {comm.items_moved} items in {REPS} calls, "
             f"not {REPS} x {items}")
    err = check_product(inst, c, *values[-1], device, what)
    stats = {
        "instance": inst.name,
        "model": handle.model,
        "shape": list(inst.shape),
        "nnz": [a_s.nnz, b_s.nnz, c_s.nnz],
        "n_mult": inst.n_mult,
        "plan_s": None if plan_s is None else round(plan_s, 3),
        "compile_s": round(compile_s, 3),
        "call_ms_median": round(statistics.median(times), 3),
        "call_ms": [round(t, 3) for t in times],
        "kernel_launches": {k: v for k, v in bsr_spgemm_local.launches.items() if v},
        "predicted_words": report["predicted_words"],
        "planned_words": report["planned_words"],
        "planned_items": report.get("planned_items"),
        "padded_words": report["padded_words"],
        "items_moved_per_call": comm.items_moved // REPS,
        "max_abs_err": err,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
    }
    del c
    return exe, dev_values[-1], stats


def main_path_block1(inst, device, rng):
    """Plan, compile and run one AMG product through the front door; check
    it against scipy in float64 at C's coordinates on the card."""
    from repro_torch.kernels.bsr_spgemm import bsr_spgemm_local

    exe, last, stats = front_door_run(inst, "monoC", device, rng)
    launches = bsr_spgemm_local.launches["scalar_runs"]
    if launches < REPS:
        fail(f"{inst.name}: {launches} kernel launches in {REPS} calls")
    plan = exe.planned.execution_plan
    stats.update(launches_per_call=launches / REPS, pairs=plan.stats["n_pairs"],
                 pairs_padded=plan.stats["pairs_padded"])
    print("main path", json.dumps(stats), flush=True)
    return exe, last, stats


def kernel_record_at(exe, a, b, library_ms):
    """K1's numbers at the shapes the main path gave it: the same inputs
    through the kernel and through its plain version."""
    a_own, b_own = exe.runtime.pack(*exe.pack(a, b))
    args = exe.runtime.step.kernel_inputs(a_own, b_own)
    a_tab, b_tab, pa, pb, pc, rs, rc, n_c = args
    err, ms, call_ms, plain_ms = check_kernel(args, TOL[dtype_name(a_tab.dtype)])
    bound_ms, bound_by, n_bytes, ops, peak = kernel_bound(a_tab, b_tab, pa, pb, rs, rc)
    return {
        "kernel": "scalar_runs",
        "max_abs_err": err,
        "ms": ms,
        "call_ms": call_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "bound_peak": peak,
        "bound_bytes": n_bytes,
        "bound_flops": ops,
        "library_ms": library_ms,
        "pairs": pa.numel(),
        "runs": rc.numel(),
        "block": a_tab.shape[-1],
    }


def profile_call(exe, a, b, call_ms: float, calls: int = 3, label: str = "27-AP") -> dict:
    """Where one front-door call's device time goes: the CUDA kernels that
    ``torch.profiler`` saw over a few calls, per call, against the median
    unprofiled call time ``call_ms`` (the idle share is the rest).  Printed,
    and returned for the phase's record (empty if the profiler saw no
    device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            exe(a, b)
        torch.cuda.synchronize()
    kernels = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
    ]
    if not kernels:
        print("profile: the profiler saw no device time (not measured)", flush=True)
        return {}
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / calls
    print(f"profile {label} call: call_ms={call_ms:.4f} device_busy_ms={busy_ms:.4f} "
          f"idle_share={1 - busy_ms / call_ms:.3f}", flush=True)
    top = [{"ms": e.self_device_time_total / 1e3 / calls, "count": e.count / calls,
            "kernel": e.key[:90]} for e in kernels[:8]]
    for k in top:
        print(f"profile   {k['ms']:.4f} ms x{k['count']:g} {k['kernel']}", flush=True)
    return {"call_ms": call_ms, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / call_ms, "kernels": top}


def csr_on_card(structure, values, device):
    import torch

    with warnings.catch_warnings():  # CSR is "beta" in PyTorch; not our concern
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            torch.as_tensor(structure.indptr, dtype=torch.int64, device=device),
            torch.as_tensor(structure.indices, dtype=torch.int64, device=device),
            values, size=structure.shape,
        )


def library_csr_ms(A, B):
    """One PyTorch call for the same product: CSR @ CSR on the card (a
    yardstick only; the port never calls it).  None if this build lacks it."""
    try:
        return cuda_ms(lambda: A @ B, reps=5, warmup=1)
    except (RuntimeError, NotImplementedError) as exc:
        print(f"library_ms: CSR @ CSR unavailable ({exc})", flush=True)
        return None


def block16_path(device, rng):
    """The tiled path: a 4096 x 4096 operand on a 256 x 256 grid of 16 x 16
    blocks at block density 0.05, squared, at p = 4."""
    import torch
    from repro_torch.distributed.plan_ir import plan_monoC_from_dense
    from repro_torch.distributed.runtime import compile_spgemm
    from repro_torch.kernels.bsr_spgemm import bsr_spgemm_local, route
    from repro_torch.sparse.bsr import to_bsr

    block, grid = 16, 256
    mask = rng.random((grid, grid)) < 0.05
    dense = rng.standard_normal((grid * block, grid * block)).astype(np.float32)
    dense *= np.kron(mask, np.ones((block, block), np.float32))
    t0 = time.perf_counter()
    plan, inst = plan_monoC_from_dense(dense, dense, block, P, seed=0)
    plan_s = time.perf_counter() - t0
    ab = to_bsr(dense, block, block)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    exe = compile_spgemm(plan, inst.a, inst.b, device=device, block=block, c_structure=inst.c)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    n = ab.n_blocks
    vals = [torch.from_numpy(rng.standard_normal((n, block, block)).astype(np.float32)).to(device)
            for _ in range(WARMUP + REPS)]
    for v in vals[:WARMUP]:
        exe(v, v)
    torch.cuda.synchronize()
    reset_launches()
    times = []
    for v in vals[WARMUP:]:
        t0 = time.perf_counter()
        c = exe.unpack(exe(v, v))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    kernel = route(block, block, block)
    launches = bsr_spgemm_local.launches[kernel]
    if launches < REPS:
        fail(f"block 16: {launches} {kernel} launches in {REPS} calls")
    # the last call against a float64 dense product on the card
    rows = torch.as_tensor(ab.brows, device=device)
    cols = torch.as_tensor(ab.bcols, device=device)
    a4 = torch.zeros((grid, grid, block, block), dtype=torch.float64, device=device)
    a4[rows, cols] = vals[-1].double()
    a64 = a4.permute(0, 2, 1, 3).reshape(grid * block, grid * block)
    want = a64 @ a64
    err = (c.double() - want).abs()
    if c.shape != want.shape or not bool(torch.isfinite(c).all()):
        fail(f"block 16: result {tuple(c.shape)} not finite or misshapen")
    if not bool((err <= 1e-4 + 1e-4 * want.abs()).all()):
        fail(f"block 16: wrong product, max abs err {err.max().item()}")
    a_own, b_own = exe.pack(vals[-1], vals[-1])
    args = exe.step.kernel_inputs(a_own, b_own)
    k_err, k_ms, k_call, k_plain = check_kernel(args, TOL["float32"])
    a_tab, b_tab, pa, pb, pc, rs, rc, n_c = args
    bound_ms, bound_by, n_bytes, ops, peak = kernel_bound(a_tab, b_tab, pa, pb, rs, rc)
    # the same product as one scalar CSR @ CSR call, on the last call's values
    with warnings.catch_warnings():  # CSR is "beta" in PyTorch; not our concern
        warnings.simplefilter("ignore", UserWarning)
        a_csr = a64.float().to_sparse_csr()
    library_ms = library_csr_ms(a_csr, a_csr)
    stats = {
        "instance": "block16-4096-d0.05-squared",
        "c_blocks": inst.c.nnz,
        "pairs": pa.numel(),
        "plan_s": round(plan_s, 3),
        "compile_s": round(compile_s, 3),
        "call_ms_median": round(statistics.median(times), 3),
        "call_ms": [round(t, 3) for t in times],
        "launches_per_call": launches / REPS,
        "planned_words": plan.comm_words_ideal,
        "padded_words": plan.comm_words_padded,
        "max_abs_err": float(err.max().item()),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
    }
    record = {"kernel": kernel, "launches": launches, "max_abs_err": k_err, "ms": k_ms,
              "call_ms": k_call, "plain_ms": k_plain, "bound_ms": bound_ms, "bound_by": bound_by,
              "bound_peak": peak, "bound_bytes": n_bytes, "bound_flops": ops,
              "library_ms": library_ms, "pairs": pa.numel(), "runs": rc.numel(), "block": block}
    print("block16 path", json.dumps(stats), flush=True)
    print("K1 at block 16", json.dumps(record), flush=True)
    return stats, record, dense


def k1_block_shapes(rng, device):
    """K1 against its plain version at rectangular and large blocks, each
    with a trailing garbage run; fp32 and bf16."""
    import torch

    from repro_torch.kernels.bsr_spgemm import route

    cases = {(8, 16, 8): (512, 0.02), (16, 8, 32): (256, 0.05),
             (64, 64, 64): (64, 0.1), (128, 128, 128): (32, 0.15)}
    records = []
    for shape, (grid, density) in cases.items():
        for dtype in (torch.float32, torch.bfloat16):
            args = random_block_case(rng, grid, shape, density, dtype, device)
            name = dtype_name(dtype)
            err, ms, call_ms, plain_ms = check_kernel(args, TOL[name])
            a_tab, b_tab, pa, pb, _, rs, rc, _ = args
            bound_ms, bound_by, _, _, peak = kernel_bound(a_tab, b_tab, pa, pb, rs, rc)
            rec = {"shape": list(shape), "dtype": name, "kernel": route(*shape),
                   "pairs": pa.numel(), "runs": rc.numel(), "max_abs_err": err, "ms": ms,
                   "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "bound_peak": peak}
            records.append(rec)
            print(f"K1 check {shape} {name} {rec['kernel']} pairs={pa.numel()} "
                  f"max_abs_err={err:.3g} ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"bound_ms={bound_ms:.4f}", flush=True)
    return records


def retiled_spgemm(dense, device, block: int):
    """``ops.spgemm`` on the block16-4096 operand retiled at block x block,
    squared, against a float64 dense product on the card; then K1 at those
    inputs against its plain version and one CSR @ CSR call."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.bsr_spgemm import (
        bsr_spgemm_local, build_pair_lists, pair_runs, route,
    )
    from repro_torch.sparse.bsr import to_bsr

    ab = to_bsr(dense, block, block)
    kernel = route(block, block, block)
    reset_launches()
    t0 = time.perf_counter()
    c_blocks, crows, ccols = ops.spgemm(ab, ab)
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) * 1e3
    launches = bsr_spgemm_local.launches[kernel]
    if launches != 1 or sum(bsr_spgemm_local.launches.values()) != 1:
        fail(f"retiled {block}: launches {bsr_spgemm_local.launches} in one ops.spgemm call")
    grid = dense.shape[0] // block
    a64 = torch.from_numpy(dense).to(device, torch.float64)
    want = a64 @ a64
    c4 = torch.zeros((grid, grid, block, block), dtype=torch.float64, device=device)
    c4[torch.as_tensor(crows, device=device), torch.as_tensor(ccols, device=device)] = (
        c_blocks.double()
    )
    c = c4.permute(0, 2, 1, 3).reshape(want.shape)
    if c_blocks.dtype != torch.float32 or not bool(torch.isfinite(c).all()):
        fail(f"retiled {block}: result {c_blocks.dtype} not float32 or not finite")
    err = max_err_within(c, want, 1e-4, f"retiled {block}: wrong product")
    # K1 alone at the same inputs
    pa, pb, pc, _, _ = build_pair_lists(ab.brows, ab.bcols, ab.brows, ab.bcols)
    rs, rc = pair_runs(pc)
    idx = lambda x: torch.as_tensor(np.asarray(x, np.int32), device=device)  # noqa: E731
    blocks = torch.from_numpy(ab.blocks).to(device)
    pa_t, pb_t, rs_t, rc_t = idx(pa), idx(pb), idx(rs), idx(rc)
    args = (blocks, blocks, pa_t, pb_t, idx(pc), rs_t, rc_t, len(crows))
    k_err, ms, k_call, plain_ms = check_kernel(args, TOL["float32"], garbage_slot=False)
    bound_ms, bound_by, n_bytes, n_ops, peak = kernel_bound(blocks, blocks, pa_t, pb_t, rs_t,
                                                            rc_t)
    with warnings.catch_warnings():  # CSR is "beta" in PyTorch; not our concern
        warnings.simplefilter("ignore", UserWarning)
        a_csr = a64.float().to_sparse_csr()
    record = {"instance": f"block16-4096-d0.05 retiled {block}x{block}, squared",
              "n_blocks": ab.n_blocks, "c_blocks": len(crows), "pairs": len(pa),
              "runs": len(rc), "kernel": kernel, "ops_call_ms": call_ms, "launches": launches,
              "max_abs_err_vs_float64": err, "max_abs_err": k_err, "ms": ms,
              "call_ms": k_call, "plain_ms": plain_ms, "bound_ms": bound_ms,
              "bound_by": bound_by, "bound_peak": peak, "bound_bytes": n_bytes,
              "bound_flops": n_ops,
              "library_ms": library_csr_ms(a_csr, a_csr)}
    print(f"K1 retiled {block}", json.dumps(record), flush=True)
    return record


def spmm_amg(a_struct, device, rng):
    """K2 at the repo's AMG size: the 27-point operator of AMG n=42 with
    seeded values, tiled 8 x 8 by scipy's BSR conversion, times a seeded
    dense (n, 256) block of vectors through ``ops.spmm`` in fp32
    (``warp_rows``) and bf16 (``mma_rows``), tiled 12 x 12 in fp32
    (``warp_blocks``) and bf16 (``mma_blocks``), the routes of every other
    block shape, and tiled 3 x 3 (3-D elasticity's blocks) in fp32; each
    checked against scipy in float64 on the same (rounded) inputs, then the kernel
    against its plain version and one PyTorch sparse @ dense call.  Beside
    the bound (each input read once) each record keeps the bytes the
    kernel gathers, one dense slab of bk rows a block, and their rate."""
    import scipy.sparse as sp
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.bsr_spmm import bsr_spmm_local, route, row_offsets
    from repro_torch.kernels.ref import bsr_spmm_ref
    from repro_torch.sparse.bsr import BlockSparse

    n_cols = 256
    t0 = time.perf_counter()
    vals = rng.standard_normal(a_struct.nnz).astype(np.float32)
    dense = rng.standard_normal((a_struct.shape[1], n_cols)).astype(np.float32)
    tiled = {}
    for block in (8, 12, 3):
        a_bsr = scipy_csr(a_struct, vals).astype(np.float32).tobsr(blocksize=(block, block))
        a_bsr.sort_indices()
        tiled[block] = a_bsr
    setup_s = time.perf_counter() - t0
    cases = (("float32", 8, torch.float32), ("bfloat16", 8, torch.bfloat16),
             ("float32_12x12", 12, torch.float32), ("bfloat16_12x12", 12, torch.bfloat16),
             ("float32_3x3", 3, torch.float32))
    records = {"instance": f"AMG n={AMG_N} 27-point A, 8x8, 12x12 and 3x3 BSR, N={n_cols}",
               "shape": list(a_struct.shape), "nnz": a_struct.nnz, "setup_s": setup_s}
    for name, block, dtype in cases:
        a_bsr = tiled[block]
        m_blocks = a_struct.shape[0] // block
        brows = np.repeat(np.arange(m_blocks), np.diff(a_bsr.indptr))
        bcols = a_bsr.indices.astype(np.int64)
        nb = len(bcols)
        blocks = torch.from_numpy(a_bsr.data).to(device, dtype)
        dense_dev = torch.from_numpy(dense).to(device, dtype)
        kernel = route(block, block, dtype)
        reset_launches()
        out = ops.spmm(BlockSparse(blocks, brows, bcols, a_struct.shape), dense_dev)
        torch.cuda.synchronize()
        launches = {k: v for k, v in bsr_spmm_local.launches.items() if v}
        if launches != {kernel: 1}:
            fail(f"K2 {name}: launches {launches} in one ops.spmm call, not {kernel}")
        if out.shape != (a_struct.shape[0], n_cols) or out.dtype != dtype:
            fail(f"K2 {name}: result {tuple(out.shape)} {out.dtype}")
        if not bool(torch.isfinite(out).all()):
            fail(f"K2 {name}: result not finite")
        tol = TOL[dtype_name(dtype)]
        # scipy in float64 on the inputs as the card saw them (bf16-rounded)
        a_seen = sp.bsr_matrix(
            (blocks.double().cpu().numpy(), a_bsr.indices, a_bsr.indptr), shape=a_struct.shape
        )
        want = torch.from_numpy(a_seen @ dense_dev.double().cpu().numpy()).to(device)
        err64 = max_err_within(out.double(), want, tol, f"K2 {name} against scipy")
        # the kernel against its plain version, on the same device tensors
        rows = torch.as_tensor(brows, device=device)
        row_start = torch.as_tensor(row_offsets(brows, m_blocks), device=device)
        cols32 = torch.as_tensor(bcols.astype(np.int32), device=device)
        args = (blocks, row_start, cols32, dense_dev, m_blocks)
        got = bsr_spmm_local(*args)
        plain = bsr_spmm_ref(blocks, rows, cols32, dense_dev, m_blocks)
        err = max_err_within(got, plain, tol, f"K2 {name} against its plain version")
        ms = graph_ms(lambda: bsr_spmm_local(*args))
        call_ms = cuda_ms(lambda: bsr_spmm_local(*args))
        plain_ms = cuda_ms(lambda: bsr_spmm_ref(blocks, rows, cols32, dense_dev, m_blocks),
                           reps=5, warmup=1)
        es = blocks.element_size()
        n_bytes = ((blocks.numel() + dense_dev.numel() + out.numel()) * es
                   + (cols32.numel() + row_start.numel()) * 4)
        n_ops = 2.0 * nb * block * block * n_cols
        bound_ms, bound_by = bound(n_bytes, n_ops, dtype_name(dtype))
        gathered = nb * block * n_cols * es  # a dense slab per block
        library_ms, library_call = spmm_library_ms(a_bsr, a_struct, vals, blocks, dense_dev,
                                                   device)
        records[name] = {
            "kernel": kernel, "block": block, "n_blocks": nb, "block_rows": m_blocks,
            "fill": a_struct.nnz / (nb * block * block),
            "launches": launches[kernel], "max_abs_err": err, "max_abs_err_vs_float64": err64,
            "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_bytes": n_bytes, "bound_flops": n_ops,
            "gathered_bytes": gathered, "gathered_tb_per_s": gathered / ms / 1e9,
            "library_ms": library_ms, "library_call": library_call,
        }
        print(f"K2 AMG {name}", json.dumps(records[name]), flush=True)
    return records


def spmm_library_ms(a_bsr, a_struct, vals, blocks, dense, device):
    """One PyTorch call for the same product (a yardstick only; the port
    never calls it): BSR @ dense where this build has it on CUDA, else CSR @
    dense on the operator's own nonzeros ``vals`` (canonical CSR order).
    Returns (ms or None, which call)."""
    import torch

    def index(x):
        return torch.as_tensor(x, dtype=torch.int64, device=device)

    with warnings.catch_warnings():  # sparse BSR/CSR are "beta" in PyTorch
        warnings.simplefilter("ignore", UserWarning)
        try:
            a = torch.sparse_bsr_tensor(index(a_bsr.indptr), index(a_bsr.indices), blocks,
                                        size=a_bsr.shape)
            return cuda_ms(lambda: a @ dense, reps=5, warmup=1), "torch.sparse_bsr_tensor @ dense"
        except (RuntimeError, NotImplementedError) as exc:
            print(f"library_ms: BSR @ dense unavailable ({exc}); trying CSR", flush=True)
        try:
            a = torch.sparse_csr_tensor(
                index(a_struct.indptr), index(a_struct.indices),
                torch.from_numpy(vals).to(device, blocks.dtype), size=a_struct.shape,
            )
            return cuda_ms(lambda: a @ dense, reps=5, warmup=1), "torch.sparse_csr_tensor @ dense"
        except (RuntimeError, NotImplementedError) as exc:
            print(f"library_ms: CSR @ dense unavailable ({exc})", flush=True)
            return None, None


def moe_qwen3(device):
    """K3 at the full width of Qwen3-MoE-235B-A22B's experts (E = 128
    experts, top-K = 8, d_model 4096, d_ff_expert 1536): T = 8192 routed
    tokens at capacity factor 1.25 give C = ceil(T K / E * 1.25) = 640 rows
    per expert.
    The up projection (E, C, d) x (E, d, f) and the down projection of its
    output (E, C, f) x (E, f, d) through ``ops.grouped_gemm`` in bf16 (both
    ``expert_wgmma``), with weights drawn N(0, 1/fan_in) so every output is
    O(1); each checked against the plain version (tolerance 2e-2 + 2e-2
    |want|: bf16 output rounding), then timed beside ``torch.bmm`` on the same
    tensors.  Then the up projection in fp32 on operands drawn in fp32 with
    full 24-bit significands (not bf16 values, which would hide a kernel
    that multiplied in bf16 or TF32): ``split3_bf16`` twice and
    ``expert_split``, checked at 1e-4 against the plain version (fp32, TF32
    off) and against a float64 product on one expert, and timed beside
    ``torch.bmm`` in fp32 (TF32 off); the split pass alone against its plain
    version, bit for bit.  What sets expert_split's error, on expert 0
    against float64: the same kernel on the bf16 values of x and w (their
    pieces x1, x2, w1, w2 are zero, so it sums x0 w0 alone in the same
    accumulators) and ``torch.bmm`` fp32 on the full-mantissa data.  Last,
    the up projection in bf16 through a view of x 2 bytes into its buffer,
    off the 16 bytes a tensor map needs: ``stage16`` copies x to an aligned
    buffer, then ``expert_wgmma``; the call timed beside its plain version
    and ``torch.bmm`` on the same view, and the stage alone held bit for bit
    to its plain version and timed beside ``clone`` (the same copy)."""
    import math

    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.moe_gemm import launch_plan, moe_gemm, split3_bf16, stage16
    from repro_torch.kernels.ref import moe_gemm_ref, split3_bf16_ref, stage16_ref

    tokens, E, K, d, f = 8192, 128, 8, 4096, 1536
    C = math.ceil(tokens * K / E * 1.25)
    g = torch.Generator(device=device).manual_seed(0)

    def normal(shape, std, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=device) * std).to(dtype)

    x = normal((E, C, d), 1.0)
    w_up = normal((E, d, f), 1 / math.sqrt(d))
    w_down = normal((E, f, d), 1 / math.sqrt(f))
    reset_launches()
    h = ops.grouped_gemm(x, w_up)
    y = ops.grouped_gemm(h, w_down)
    torch.cuda.synchronize()
    launches = {k: v for k, v in moe_gemm.launches.items() if v}
    if launches != {"expert_wgmma": 2}:
        fail(f"K3: launches {launches} in two bf16 ops.grouped_gemm calls")
    records = {"config": "Qwen3-MoE-235B-A22B experts", "E": E, "top_k": K, "tokens": tokens,
               "C": C, "d_model": d, "d_ff_expert": f}

    def record(xi, wi, out, kernel, n_launches, tol, reps, peak):
        """Check ``out`` against the plain version; time the kernel, the
        plain version and ``torch.bmm`` on the same tensors (by events:
        these kernels take milliseconds)."""
        dtype = dtype_name(xi.dtype)
        if out.shape != (E, C, wi.shape[2]) or out.dtype != xi.dtype:
            fail(f"K3 {kernel} {dtype}: result {tuple(out.shape)} {out.dtype}")
        if not bool(torch.isfinite(out).all()):
            fail(f"K3 {kernel} {dtype}: result not finite")
        want = moe_gemm_ref(xi, wi)
        err = max_err_within(out, want, tol, f"K3 {kernel} {dtype} against its plain version")
        del want
        ms = cuda_ms(lambda: moe_gemm(xi, wi), reps=reps)
        plain_ms = cuda_ms(lambda: moe_gemm_ref(xi, wi), reps=2, warmup=1)
        library_ms = cuda_ms(lambda: torch.bmm(xi, wi), reps=reps)
        n_bytes = (xi.numel() + wi.numel() + out.numel()) * xi.element_size()
        n_ops = 2.0 * E * C * xi.shape[2] * wi.shape[2]
        bound_ms, bound_by = bound(n_bytes, n_ops, peak)
        return {
            "kernel": kernel, "dtype": dtype, "shape": [list(xi.shape), list(wi.shape)],
            "launches": n_launches, "max_abs_err": err,
            "out_std": float(out.float().std().item()), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bound_peak": peak,
            "bound_bytes": n_bytes, "bound_flops": n_ops, "library_ms": library_ms,
            "library_call": "torch.bmm",
        }

    for name, (xi, wi, out) in (("up", (x, w_up, h)), ("down", (h, w_down, y))):
        records[name] = record(xi, wi, out, "expert_wgmma", launches["expert_wgmma"],
                               TOL["bfloat16"], reps=20, peak="bfloat16")
        print(f"K3 {name}", json.dumps(records[name]), flush=True)
    del x, w_up, w_down, h, y, xi, wi, out

    # the fp32 route, at the up projection's shape, on full-mantissa fp32 data
    x32 = normal((E, C, d), 1.0, torch.float32)
    w32 = normal((E, d, f), 1 / math.sqrt(d), torch.float32)
    for name, t in (("x", x32), ("w", w32)):
        if not bool((t != t.bfloat16().float()).any()):
            fail(f"K3 fp32: {name} holds only bf16 values")
    reset_launches()
    out32 = ops.grouped_gemm(x32, w32)
    torch.cuda.synchronize()
    launches = {k: v for k, v in moe_gemm.launches.items() if v}
    if launches != {"split3_bf16": 2, "expert_split": 1}:
        fail(f"K3: launches {launches} in one fp32 ops.grouped_gemm call")
    want64 = x32[0].double() @ w32[0].double()
    err64 = max_err_within(out32[0].double(), want64, TOL["float32"],
                           "K3 expert_split against float64 on expert 0")
    # the error of summing in the kernel's accumulators, without the pieces
    xb, wb = x32[:1].bfloat16().float(), w32[:1].bfloat16().float()
    bf16_err64 = max_err_within(moe_gemm(xb, wb)[0].double(), xb[0].double() @ wb[0].double(),
                                TOL["float32"], "K3 expert_split on bf16 values, expert 0")
    bmm_err64 = max_err_within(torch.bmm(x32[:1], w32[:1])[0].double(), want64, TOL["float32"],
                               "torch.bmm fp32 against float64 on expert 0")
    del want64, xb, wb
    rec = record(x32, w32, out32, "expert_split", launches["expert_split"], TOL["float32"],
                 reps=5, peak="float32_split")
    rec.update(max_abs_err_vs_float64_expert0=err64,
               bf16_values_max_abs_err_vs_float64_expert0=bf16_err64,
               library_max_abs_err_vs_float64_expert0=bmm_err64)
    records["up_fp32"] = rec
    print("K3 up fp32", json.dumps(rec), flush=True)
    del out32
    # the split pass alone, on the same operands
    for name, t in (("x", x32), ("w", w32)):
        if not torch.equal(split3_bf16(t), split3_bf16_ref(t)):
            fail(f"K3 split3_bf16 of {name} differs from its plain version")
    n = x32.numel() + w32.numel()
    bound_ms, bound_by = bound(10.0 * n, 0.0, "float32")  # 4 bytes read, 6 written a value
    rec = {"kernel": "split3_bf16", "launches": launches["split3_bf16"], "max_abs_err": 0.0,
           "ms": cuda_ms(lambda: (split3_bf16(x32), split3_bf16(w32)), reps=5),
           "plain_ms": cuda_ms(lambda: (split3_bf16_ref(x32), split3_bf16_ref(w32)), reps=2,
                               warmup=1),
           "bound_ms": bound_ms, "bound_by": bound_by, "bound_peak": None,
           "bound_bytes": 10.0 * n, "bound_flops": 0.0, "library_ms": None, "values": n}
    records["split_fp32"] = rec
    print("K3 split3_bf16 (x and w of the fp32 up projection)", json.dumps(rec), flush=True)
    # the bf16 up projection through a misaligned view of x: stage16, then
    # expert_wgmma
    x_mis = torch.empty(E * C * d + 1, dtype=torch.bfloat16, device=device)[1:].view(E, C, d)
    x_mis.copy_(x32)
    w_bf16 = w32.bfloat16()
    del x32, w32
    plan = {"stage16": 1, "expert_wgmma": 1}
    if x_mis.data_ptr() % 16 != 2 or launch_plan(x_mis, w_bf16) != plan:
        fail(f"K3 misaligned bf16 view: data_ptr() % 16 = {x_mis.data_ptr() % 16}, "
             f"launch plan {launch_plan(x_mis, w_bf16)}")
    reset_launches()
    out_mis = ops.grouped_gemm(x_mis, w_bf16)
    torch.cuda.synchronize()
    launches = {k: v for k, v in moe_gemm.launches.items() if v}
    if launches != plan:
        fail(f"K3: launches {launches} in one misaligned bf16 ops.grouped_gemm call")
    rec = record(x_mis, w_bf16, out_mis, "stage16 + expert_wgmma", launches["expert_wgmma"],
                 TOL["bfloat16"], reps=10, peak="bfloat16")
    records["staged_misaligned"] = rec
    print("K3 up bf16, x 2 bytes off", json.dumps(rec), flush=True)
    del out_mis
    # the stage alone: a fresh aligned copy of x, bit for bit its plain version's
    staged = stage16(x_mis, d)
    if staged.data_ptr() % 16 or not torch.equal(staged.view(torch.int16),
                                                 stage16_ref(x_mis, d).view(torch.int16)):
        fail("K3 stage16 of the misaligned x differs from its plain version")
    del staged
    n_bytes = 2.0 * x_mis.numel() * x_mis.element_size()  # read once, written once
    bound_ms, bound_by = bound(n_bytes, 0.0, "bfloat16")
    rec = {"kernel": "stage16", "launches": launches["stage16"], "max_abs_err": 0.0,
           "ms": cuda_ms(lambda: stage16(x_mis, d), reps=10),
           "plain_ms": cuda_ms(lambda: stage16_ref(x_mis, d), reps=5, warmup=1),
           "bound_ms": bound_ms, "bound_by": bound_by, "bound_peak": None,
           "bound_bytes": n_bytes, "bound_flops": 0.0,
           "library_ms": cuda_ms(lambda: x_mis.clone(), reps=10), "library_call": "clone",
           "values": x_mis.numel()}
    records["stage_misaligned"] = rec
    print("K3 stage16 (x of the bf16 up projection, 2 bytes off)", json.dumps(rec), flush=True)
    return records


def moe_edges(device):
    """Every route off its tile grid against the plain version:
    ``expert_wgmma`` in bf16 and fp16 and ``expert_split`` in fp32 (full
    mantissas), with C off 64 and 128 rows, d off 64, f off 128 and 256, and
    expert boundaries inside a 128-row box; d off a multiple of 8 (x's row
    pitch), f off one (w's and the output's), and both, in bf16, fp16, fp32
    and mixed (bf16 x, fp32 w), each also with x a view one value into its
    buffer: the 16-bit ones take ``stage16`` before ``expert_wgmma`` (and
    after it, for the output, with f off 8), the fp32 and mixed ones
    ``split3_bf16``'s padded pieces; a w view off alignment in fp16; and
    ``expert_split`` held to its six products (``split_products``).  Each
    call must launch what ``launch_plan`` lists."""
    import torch
    from repro_torch.kernels.moe_gemm import launch_plan, moe_gemm
    from repro_torch.kernels.ref import moe_gemm_ref

    g = torch.Generator(device=device).manual_seed(1)
    records = []

    def check(x, w, what):
        plan = launch_plan(x, w)
        before = dict(moe_gemm.launches)
        E, C, d = x.shape
        got = moe_gemm(x, w, b_c=C, b_f=w.shape[2], b_d=d)
        torch.cuda.synchronize()
        moved = {k: v - before[k] for k, v in moe_gemm.launches.items() if v != before[k]}
        if moved != plan:
            fail(f"K3 {what}: launches {moved}, not {plan}")
        err = max_err_within(got, moe_gemm_ref(x, w), TOL[dtype_name(x.dtype)], f"K3 {what}")
        records.append({"what": what, "launches": plan, "max_abs_err": err})
        print(f"K3 edge {what} {plan} max_abs_err={err:.3g}", flush=True)

    def operands(shape, x_dtype, w_dtype, x_off=0, w_off=0):
        E, C, d, f = shape
        x = torch.randn(E * C * d + x_off, generator=g, device=device)[x_off:].to(x_dtype)
        w = torch.randn(E * d * f + w_off, generator=g, device=device)[w_off:] / d**0.5
        if x_off:  # the cast made a fresh buffer: view it off alignment again
            x = torch.empty(E * C * d + x_off, dtype=x_dtype, device=device)[x_off:].copy_(x)
        w = w.to(w_dtype)
        if w_off:
            w = torch.empty(E * d * f + w_off, dtype=w_dtype, device=device)[w_off:].copy_(w)
        return x.view(E, C, d), w.view(E, d, f)

    dtypes = {"bfloat16": (torch.bfloat16,) * 2, "float16": (torch.float16,) * 2,
              "float32": (torch.float32,) * 2, "mixed": (torch.bfloat16, torch.float32)}
    for shape in ((3, 200, 72, 136), (2, 256, 512, 384), (5, 96, 4096, 1536)):
        for name in ("bfloat16", "float16", "float32"):
            check(*operands(shape, *dtypes[name]), f"{shape} {name}")
    # d off 8, f off 8, both (odd), at one and several k-blocks
    for shape in ((3, 200, 36, 136), (2, 256, 512, 100), (2, 130, 1001, 257), (2, 64, 4100, 20)):
        for name, (x_dtype, w_dtype) in dtypes.items():
            for x_off in (0, 1):
                what = f"{shape} {name}" + (", x one value off" if x_off else "")
                check(*operands(shape, x_dtype, w_dtype, x_off=x_off), what)
    shape = (2, 256, 512, 384)
    for name, x_off in (("float32", 1), ("bfloat16", 1)):
        check(*operands(shape, *dtypes[name], x_off=x_off), f"{shape} {name}, x one value off")
    check(*operands(shape, *dtypes["float16"], w_off=3), f"{shape} float16, w 3 values off")
    records.append(split_products(device))
    return records


def split_products(device):
    """``expert_split`` sums all six products x_i w_j (i + j <= 2) of the
    bf16 pieces: at d = 64, one k-block, where summing in the tensor cores'
    accumulators costs little, the result is held to those products of
    ``split3_bf16_ref``'s pieces summed in float64, within half the largest
    term of the smallest product.  A kernel that dropped any product would
    miss by at least twice that; the three-product, two-piece scheme's miss
    is recorded beside it."""
    import torch
    from repro_torch.kernels.moe_gemm import moe_gemm
    from repro_torch.kernels.ref import split3_bf16_ref

    E, C, d, f = 2, 256, 64, 256
    g = torch.Generator(device=device).manual_seed(2)
    x = torch.randn((E, C, d), generator=g, device=device)
    w = torch.randn((E, d, f), generator=g, device=device) / d**0.5
    xs, ws = split3_bf16_ref(x).double(), split3_bf16_ref(w).double()
    terms = {(i, j): xs[i] @ ws[j] for i in range(3) for j in range(3 - i)}
    want = sum(terms.values())
    tol = min(t.abs().max().item() for t in terms.values()) / 2
    two_piece = (terms[0, 0] + terms[0, 1] + terms[1, 0] - want).abs().max().item()
    err = (moe_gemm(x, w).double() - want).abs().max().item()
    if not err < tol:
        fail(f"K3 expert_split misses its six products by {err} (tolerance {tol})")
    rec = {"what": f"{(E, C, d, f)} float32, six products", "kernel": "expert_split",
           "max_abs_err": err, "tol": tol, "two_piece_max_abs_err": two_piece}
    print("K3 expert_split products", json.dumps(rec), flush=True)
    return rec


NEW_MODELS = ("rowwise", "columnwise", "outer", "fine", "monoA", "monoB")


def every_model(ap, ptap, ptap_stats, device, rng):
    """Phase 9: the other six paper models and ``model="auto"`` through the
    front door, each checked as ``front_door_run`` does.  (a) 27-PTAP at
    n=42, the six models (monoC's record is phase 4's); (b) LP-pds100 at
    scale 1 (A A^T of the interior-point normal equations), all seven, then
    ``model="auto"``, whose ``.selection`` must be the seven cost reports
    with the minimum selected, and its executor; (c) 27-AP at n=42, the 1D
    models, whose dense local products (30-34 TFLOP a call) are the card's
    work, with a profile of one rowwise and one outer call."""
    import torch
    import repro_torch
    from repro_torch.core.matrices import lp_instance

    records = {ptap.name: {"monoC": ptap_stats}}

    def run(inst, model, handle=None):
        t0 = time.perf_counter()
        exe, last, rec = front_door_run(inst, model, device, rng, handle)
        rec["seconds"] = round(time.perf_counter() - t0, 3)
        key = "auto" if handle is not None else model
        records.setdefault(inst.name, {})[key] = rec
        print(f"every model {inst.name} {key}", json.dumps(rec), flush=True)
        torch.cuda.empty_cache()
        return exe, last, rec

    t0 = time.perf_counter()
    for model in NEW_MODELS:
        run(ptap, model)
    phase("every model (a) 27-PTAP", t0)

    t0 = time.perf_counter()
    lp = lp_instance("pds100")
    reports = {}
    for model in repro_torch.MODELS:
        exe, _, _ = run(lp, model)
        reports[model] = exe.planned.cost_report()
    t1 = time.perf_counter()
    auto = repro_torch.plan(lp, p=P, model="auto", seed=0)
    auto_plan_s = time.perf_counter() - t1
    chosen = [r["model"] for r in auto.selection if r["selected"]]
    best = min(reports, key=lambda m: reports[m]["predicted_words"])
    if [{k: v for k, v in r.items() if k != "selected"} for r in auto.selection] != [
        reports[m] for m in repro_torch.executable_models()
    ]:
        fail(f"{lp.name}: auto's selection differs from the seven per-model cost reports")
    if chosen != [auto.model] or reports[auto.model]["predicted_words"] != \
            reports[best]["predicted_words"]:
        fail(f"{lp.name}: auto selected {chosen}, not the minimum {best}")
    _, _, rec = run(lp, "auto", handle=auto)
    rec.update(plan_s=round(auto_plan_s, 3), selected=auto.model,
               predicted_words_by_model={m: r["predicted_words"] for m, r in reports.items()})
    print(f"every model {lp.name} auto selected {auto.model} "
          f"({reports[auto.model]['predicted_words']} words)", flush=True)
    phase("every model (b) LP-pds100", t0)

    t0 = time.perf_counter()
    for model in ("rowwise", "columnwise", "outer"):
        exe, (a, b), rec = run(ap, model)
        if model in ("rowwise", "outer"):
            rec["profile"] = profile_call(exe, a, b, rec["call_ms_median"], calls=2,
                                          label=f"27-AP {model}")
            torch.cuda.empty_cache()
    phase("every model (c) 27-AP, 1D", t0)
    return records


def drifted(structure, frac: float, rng):
    """``structure`` with ``frac`` of its nonzeros dropped and as many added at
    seeded positions in the same rows (columns the row does not hold)."""
    from repro_torch.sparse.structure import from_coo

    rows, cols = structure.coo()
    n_cols = structure.shape[1]
    drop = rng.choice(len(rows), int(frac * len(rows)), replace=False)
    keep = np.ones(len(rows), bool)
    keep[drop] = False
    taken = set((rows * n_cols + cols).tolist())
    new_cols = []
    for r in rows[drop].tolist():
        while (c := int(rng.integers(n_cols))) in taken:
            pass
        taken.add(r * n_cols + c)
        new_cols.append(c)
    return from_coo(np.r_[rows[keep], rows[drop]], np.r_[cols[keep], new_cols],
                    structure.shape)


def serving(device, rng):
    """Phase 10: the serving tier at p = 4, fp32, ``model="monoC"`` (K1
    ``scalar_runs`` at block 1), on LP-pds100 A A^T (the interior-point
    normal equations).  (a) A stream of 64 multiplies with fresh values:
    64 unbatched calls, then 8 dispatches of ``compile(batch=8)``, with
    multiplies/s and K1 launches (64 and 8) of each; every batched result
    against its unbatched twin, 4 of them against scipy in float64.  (b) A
    ``SpGEMMServer`` (max_batch 8, window 16, 4 pool entries, a plan store in
    a temporary directory) drains 48 interleaved requests in windows of 16:
    24 pds100 (pool hits after the first), 16 pds80 (cold, then hits) and 8
    of pds100 with 2% of A's nonzeros moved within their rows, times its
    transpose (a warm replan); each result against scipy in float64, then
    released.  Any downgrade, fallback, retry, store error or failed
    request fails the phase, as do K1 launches other than one a dispatch.
    (c) A second server on the same store replays 8 requests: every
    structure restored, no ``"partition"`` call.  (d) A fault scripted at
    ``"execute"`` once: one retry, results still right."""
    import tempfile

    import torch
    import repro_torch
    from repro_torch.core.matrices import lp_instance
    from repro_torch.core.spgemm_models import SpGEMMInstance
    from repro_torch.kernels.bsr_spgemm import bsr_spgemm_local
    from repro_torch.launch.serve import SpGEMMServer
    from repro_torch.testing import faults

    torch.cuda.reset_peak_memory_stats()
    pds100, pds80 = lp_instance("pds100"), lp_instance("pds80")
    drift_a = drifted(pds100.a, 0.02, rng)
    drift = SpGEMMInstance(drift_a, drift_a.transpose(), name="LP-pds100-drift2%")
    record = {}

    def fresh(inst):
        return (rng.standard_normal(inst.a.nnz).astype(np.float32),
                rng.standard_normal(inst.b.nnz).astype(np.float32))

    def k1_launches():
        return bsr_spgemm_local.launches["scalar_runs"]

    # (a) the stream: looped against batched, on one structure
    t0 = time.perf_counter()
    handle = repro_torch.plan(pds100, p=P, model="monoC", seed=0)
    plan_s = time.perf_counter() - t0
    one, batched = handle.compile(device=device), handle.compile(device=device, batch=8)
    values = [fresh(pds100) for _ in range(64)]
    stacks = [tuple(np.stack(v) for v in zip(*values[i:i + 8])) for i in range(0, 64, 8)]
    one(*values[0]), batched(*stacks[0])  # warm
    torch.cuda.synchronize()
    rates = {}
    for name, exe, args in (("looped", one, values), ("batched", batched, stacks)):
        reset_launches()
        t0 = time.perf_counter()
        for a, b in args:
            c = exe(a, b)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        del c
        rates[name] = {"seconds": seconds, "multiplies_per_s": 64 / seconds,
                       "k1_launches": k1_launches(), "calls": len(args)}
        if rates[name]["k1_launches"] != len(args):
            fail(f"serving (a) {name}: {k1_launches()} K1 launches in {len(args)} calls")
        rates[name]["profile"] = profile_call(exe, *args[0], seconds / len(args) * 1e3,
                                              calls=2, label=f"LP-pds100 monoC {name}")
    bit_equal, max_twin_diff, scipy_err = 0, 0.0, []
    for i, (a, b) in enumerate(stacks):
        c_batch = batched(a, b)
        for j in range(8):
            c_one = one(a[j], b[j])
            bit_equal += int(torch.equal(c_batch[j], c_one))
            max_twin_diff = max(max_twin_diff, max_err_within(
                c_batch[j], c_one, 1e-5, f"serving (a): batched result {8 * i + j} "
                                         "differs from its unbatched twin"))
            if j == 0 and i % 2 == 0:
                scipy_err.append(check_product(pds100, c_batch[j], a[j], b[j], device,
                                               f"serving (a) batched {8 * i}"))
            del c_one
        del c_batch
    record["stream"] = {
        "instance": pds100.name, "plan_s": plan_s, **rates,
        "batched_over_looped": rates["batched"]["multiplies_per_s"]
        / rates["looped"]["multiplies_per_s"],
        "bit_equal_twins": bit_equal, "max_twin_diff": max_twin_diff,
        "max_abs_err_vs_scipy": max(scipy_err),
    }
    print("serving (a) stream", json.dumps(record["stream"]), flush=True)
    del one, batched, handle
    torch.cuda.empty_cache()

    def check_and_release(requests, inst_of):
        errs = []
        for req in requests:
            if req.error is not None or req.result is None:
                fail(f"serving: request {req.rid} failed: {req.error!r}")
            inst = inst_of[id(req.a_s)]
            errs.append(check_product(inst, req.result, req.a_vals, req.b_vals, device,
                                      f"serving request {req.rid} ({inst.name})"))
            req.result = None
        return errs

    inst_of = {id(i.a): i for i in (pds100, pds80, drift)}
    cycle = (pds100, pds80, pds100, pds100, pds80, drift)  # 24 : 16 : 8 over 48
    with tempfile.TemporaryDirectory(prefix="plan_store_") as store:
        config = dict(p=P, model="monoC", max_batch=8, batch_window=16, pool_entries=4,
                      store_dir=store, device=str(device))
        # (b) the loop: 48 requests in three windows of 16
        server = SpGEMMServer(**config)
        planning = []  # (the session's events, seconds) of each group's entry_for
        entry_for = server.session.entry_for

        def timed_entry_for(a_s, b_s):
            n0, t0 = len(server.session.events), time.perf_counter()
            entry = entry_for(a_s, b_s)
            planning.append(([e.kind for e in server.session.events[n0:]],
                             time.perf_counter() - t0))
            return entry

        server.session.entry_for = timed_entry_for
        traffic = [(inst, fresh(inst)) for inst in cycle * 8]
        reset_launches()
        errs, step_s = [], 0.0
        for w in range(3):
            window = [server.submit((inst.a, va), (inst.b, vb))
                      for inst, (va, vb) in traffic[16 * w:16 * w + 16]]
            t0 = time.perf_counter()
            server.step()
            step_s += time.perf_counter() - t0
            errs += check_and_release(window, inst_of)
        report = server.report()
        events = server.session.stats()["events"]
        launches = k1_launches()
        record["loop"] = {
            "report": report, "events": events, "steps_s": step_s,
            "qps_in_steps": report["completed"] / step_s, "k1_launches": launches,
            "entry_for_s": planning,
            "dispatch_s": step_s - sum(seconds for _, seconds in planning),
            "max_abs_err_vs_scipy": max(errs),
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
        }
        print("serving (b) loop", json.dumps(record["loop"]), flush=True)
        unscripted = {k: events.get(k, 0) for k in
                      ("model_downgrade", "engine_fallback", "retry", "store_error")}
        if any(unscripted.values()) or report["failed"] or report["completed"] != 48:
            fail(f"serving (b): unscripted events {unscripted}, report {report}")
        if events.get("cold_replan") != 2 or not events.get("warm_replan"):
            fail(f"serving (b): expected 2 cold replans and a warm one, got {events}")
        if launches != report["dispatches"]:
            fail(f"serving (b): {launches} K1 launches for {report['dispatches']} dispatches")

        # (c) restart: a second server on the same store
        server = SpGEMMServer(**config)
        faults.reset_counts()
        replay = [(inst, fresh(inst)) for inst in cycle + (pds80, drift)]
        replay = [server.submit((inst.a, va), (inst.b, vb)) for inst, (va, vb) in replay]
        server.drain()
        errs = check_and_release(replay, inst_of)
        events = server.session.stats()["events"]
        record["restart"] = {"events": events, "calls": faults.call_counts(),
                             "report": server.report(), "max_abs_err_vs_scipy": max(errs)}
        print("serving (c) restart", json.dumps(record["restart"]), flush=True)
        if events.get("restored") != 3 or faults.call_counts().get("partition", 0):
            fail(f"serving (c): the restart replanned: {record['restart']}")
        if events.get("retry") or server.stats.failed:
            fail(f"serving (c): unscripted retry or failure: {record['restart']}")

        # (d) a transient fault scripted at "execute", once
        requests = [fresh(pds100) for _ in range(4)]
        requests = [server.submit((pds100.a, va), (pds100.b, vb)) for va, vb in requests]
        with faults.inject("execute", times=1) as script:
            server.drain()
        errs = check_and_release(requests, inst_of)
        retries = [e.detail for e in server.session.events if e.kind == "retry"]
        record["fault"] = {"fired": script.fired, "retries": retries,
                           "report": server.report(), "max_abs_err_vs_scipy": max(errs)}
        print("serving (d) fault", json.dumps(record["fault"], default=str), flush=True)
        if script.fired != 1 or len(retries) != 1 or retries[0]["stage"] != "execute":
            fail(f"serving (d): expected one retry at execute, got {retries}")
        if server.stats.failed:
            fail(f"serving (d): {server.stats.failed} requests failed")
    return record


def main() -> None:
    if not (SRC / "repro_torch").is_dir():
        fail("src/repro_torch not found: run from the root of a repository checkout")
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 references in full fp32
    device = torch.device("cuda", 0)
    from repro_torch.core.matrices import amg_instances
    from repro_torch.kernels import _build
    from repro_torch.kernels.bsr_spgemm import bsr_spgemm_local, route

    t0 = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    card_line = card[0] if card else "nvidia-smi: no output"
    print(f"card: {card_line} | torch: {torch.cuda.get_device_name(0)} "
          f"| torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    phase("card", t0)

    t0 = time.perf_counter()
    for name, log in _build.build_all().items():
        for line in log.splitlines():
            if any(k in line for k in ("registers", "spill", "Compiling entry", "wgmma")):
                print(f"ptxas[{name}] {line.strip()}")
    for lib in ("moe_gemm", "bsr_spgemm"):  # expert_wgmma, expert_split; mma_runs
        hgmma = sum("HGMMA" in line for line in _build.sass(lib).splitlines())
        print(f"sass[{lib}] HGMMA instructions: {hgmma}", flush=True)
        if hgmma == 0:
            fail(f"no HGMMA in the {lib} library: its wgmma kernels are not on the tensor cores")
    phase("build", t0)

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    cases = {1: (4096, 0.002), 8: (512, 0.02), 16: (256, 0.05), 32: (128, 0.05)}
    for block, (grid, density) in cases.items():
        for dtype in (torch.float32, torch.bfloat16):
            args = random_block_case(rng, grid, (block,) * 3, density, dtype, device)
            name = str(dtype).removeprefix("torch.")
            err, ms, _, plain_ms = check_kernel(args, TOL[name])
            print(f"K1 check b={block} {name} {route(block, block, block)} "
                  f"pairs={args[2].numel()} max_abs_err={err:.3g} ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f}", flush=True)
    phase("kernel checks", t0)

    t0 = time.perf_counter()
    ap, ptap = amg_instances(AMG_N)
    phase("AMG instances", t0)
    t0 = time.perf_counter()
    exe_ap, (a_last, b_last), ap_stats = main_path_block1(ap, device, rng)
    scalar_launches = bsr_spgemm_local.launches["scalar_runs"]
    _, _, ptap_stats = main_path_block1(ptap, device, rng)
    scalar_launches += bsr_spgemm_local.launches["scalar_runs"]
    phase("main path block 1", t0)

    t0 = time.perf_counter()
    library_ms = library_csr_ms(
        csr_on_card(ap.a, a_last, device), csr_on_card(ap.b, b_last, device)
    )
    scalar = kernel_record_at(exe_ap, a_last, b_last, library_ms)
    scalar["launches"] = scalar_launches
    print("K1 at 27-AP", json.dumps(scalar), flush=True)
    ap_stats["profile"] = profile_call(exe_ap, a_last, b_last, ap_stats["call_ms_median"])
    phase("K1 at the main path's shapes", t0)

    t0 = time.perf_counter()
    block16_stats, blocked, block16_dense = block16_path(device, rng)
    phase("block 16 path", t0)

    t0 = time.perf_counter()
    shape_checks = k1_block_shapes(rng, device)
    retiled = {block: retiled_spgemm(block16_dense, device, block) for block in (32, 64)}
    phase("K1 every block shape", t0)

    t0 = time.perf_counter()
    spmm = spmm_amg(ap.a, device, rng)
    phase("K2 AMG SpMM", t0)

    t0 = time.perf_counter()
    moe = moe_qwen3(device)
    phase("K3 Qwen3-MoE experts", t0)

    t0 = time.perf_counter()
    moe["edges"] = moe_edges(device)
    phase("K3 edge sweep", t0)

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    models = every_model(ap, ptap, ptap_stats, device, rng)
    phase("every model", t0)

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    served = serving(device, rng)
    phase("serving", t0)

    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps({
        "card": card_line, "ap": ap_stats, "ptap": ptap_stats, "k1_ap": scalar,
        "block16": block16_stats, "k1_block16": blocked, "k1_shapes": shape_checks,
        "k1_retiled": retiled, "k2_amg": spmm, "k3_qwen3_moe": moe, "every_model": models,
        "serving": served,
    }, indent=1, default=str))
    # one entry per __global__, each read on the path that launches it
    k1, k2, k3 = ("src/repro/kernels/bsr_spgemm.py:63", "src/repro/kernels/bsr_spmm.py:69",
                  "src/repro/kernels/moe_gemm.py:61")
    k1_paths = {rec["kernel"]: rec for rec in (blocked, retiled[32], retiled[64])}
    entries = [
        ("bsr_spgemm/scalar_runs", "bsr_spgemm.cu", k1, scalar),
        ("bsr_spgemm/warp_runs", "bsr_spgemm.cu", k1, k1_paths["warp_runs"]),
        ("bsr_spgemm/tile_runs", "bsr_spgemm.cu", k1, k1_paths["tile_runs"]),
        ("bsr_spgemm/mma_runs", "bsr_spgemm.cu", k1, k1_paths["mma_runs"]),
        ("bsr_spmm/warp_rows", "bsr_spmm.cu", k2, spmm["float32"]),
        ("bsr_spmm/mma_rows", "bsr_spmm.cu", k2, spmm["bfloat16"]),
        ("bsr_spmm/warp_blocks", "bsr_spmm.cu", k2, spmm["float32_12x12"]),
        ("bsr_spmm/mma_blocks", "bsr_spmm.cu", k2, spmm["bfloat16_12x12"]),
        ("moe_gemm/expert_wgmma", "moe_gemm.cu", k3, moe["up"]),
        ("moe_gemm/expert_split", "moe_gemm.cu", k3, moe["up_fp32"]),
        ("moe_gemm/split3_bf16", "moe_gemm.cu", k3, moe["split_fp32"]),
        ("moe_gemm/stage16", "moe_gemm.cu", k3, moe["stage_misaligned"]),
    ]
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [
        {"name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{source}",
         "replaces": replaces, **{k: rec[k] for k in keys}}
        for name, source, replaces, rec in entries
    ]
    for k in kernels:
        if not k["launches"]:
            fail(f"{k['name']}: no launch on its path")
        if k["ms"] < k["bound_ms"]:  # the bound or the timing is wrong
            fail(f"{k['name']} took {k['ms']} ms, under its bound {k['bound_ms']} ms")
    print(json.dumps({"kernels": kernels}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
