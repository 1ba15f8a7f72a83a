#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

Run from the repository root, with no arguments:  python3 chip_smoke.py

Phases, each printing its seconds:
  1. the card (nvidia-smi name and power limit, torch's device name);
  2. build every CUDA source of the port with nvcc (``-Xptxas -v`` lines);
  3. the BSR SpGEMM kernel against its plain PyTorch version on seeded
     random block matrices, b in {1, 8, 16, 32}, fp32 and bf16, plus a pair
     list with a trailing garbage run;
  4. the main path at block 1: ``repro_torch.plan(inst, p=4, model="monoC")``
     then ``.compile()`` on the card for the AMG n=42 Galerkin products
     27-AP and 27-PTAP, checked against scipy in float64; then the kernel
     timed on 27-AP's own kernel inputs against its plain version and
     against one CSR @ CSR call, and a profiler breakdown of one call;
  5. the tiled path at block 16: ``plan_monoC_from_dense`` on a seeded
     4096 x 4096 block-sparse operand, squared, checked against a float64
     dense product on the card.
Then one JSON line of per-kernel numbers (one entry per __global__ of the
kernel source: ``scalar_runs`` on the block-1 path, ``block_runs`` on the
block-16 path), the card line, and the result line; the phases' full
records go to ``chiprun_out/chip_smoke.json``.  Any failure exits non-zero without the result line; there is no CPU
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
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
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


def kernel_bound(a_tab, pa, pb, run_start, run_c):
    """Least time (ms) for the kernel's work and what bounds it.  Bytes: the
    A and B slots the pair list reads (each once), the four index arrays it
    reads, and one written C block per run, over the HBM rate.  Operations:
    the multiply-adds of this pair list over the peak for the input type.
    Table slots no pair reads (padding, unused receive slots) are not
    counted, nor are C slots no run writes."""
    import torch

    es = a_tab.element_size()
    block = a_tab.shape[-1]
    slots = torch.unique(pa).numel() + torch.unique(pb).numel()
    n_bytes = (
        (slots + run_c.numel()) * block * block * es
        + sum(t.numel() * t.element_size() for t in (pa, pb, run_start, run_c))
    )
    ops = 2.0 * pa.numel() * block**3
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_FLOPS[str(a_tab.dtype).removeprefix("torch.")]
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops) * 1e3, bound_by, n_bytes, ops


def random_block_case(rng, grid: int, block: int, density: float, dtype, device):
    """Seeded random block matrices A, B (grid x grid blocks) and their pair
    lists, with a trailing run of padding pairs into a garbage C slot."""
    import torch
    from repro_torch.kernels.bsr_spgemm import build_pair_lists, pair_runs

    def blocks():
        coords = np.argwhere(rng.random((grid, grid)) < density)
        vals = rng.standard_normal((len(coords) + 1, block, block)).astype(np.float32)
        vals[-1] = 0.0  # the all-zero slot padding pairs read
        return coords, vals

    (ac, av), (bc, bv) = blocks(), blocks()
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
    from repro_torch.kernels.bsr_spgemm import bsr_spgemm_local

    for kernel in bsr_spgemm_local.launches:
        bsr_spgemm_local.launches[kernel] = 0


def check_kernel(args, tol: float):
    """Kernel against the plain version on the same inputs; returns
    (max_abs_err, kernel ms, plain ms)."""
    import torch
    from repro_torch.kernels.bsr_spgemm import bsr_spgemm_local
    from repro_torch.kernels.ref import bsr_spgemm_ref

    a, b, pa, pb, pc, rs, rc, n_c = args
    got = bsr_spgemm_local(*args)
    want = bsr_spgemm_ref(a, b, pa, pb, pc, n_c)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    if not bool((err <= tol + tol * want.float().abs()).all()):
        fail(f"kernel disagrees with its plain version: max abs err {err.max().item()}")
    if got[-1].any():
        fail("the garbage C slot is not zero")
    ms = cuda_ms(lambda: bsr_spgemm_local(*args))
    plain_ms = cuda_ms(lambda: bsr_spgemm_ref(a, b, pa, pb, pc, n_c))
    return float(err.max().item()), ms, plain_ms


def scipy_csr(structure, values):
    import scipy.sparse as sp

    return sp.csr_matrix(
        (values.astype(np.float64), structure.indices, structure.indptr),
        shape=structure.shape,
    )


def main_path_block1(inst, device, rng):
    """Plan, compile and run one AMG product through the front door; check
    it against scipy in float64 at C's coordinates on the card."""
    import torch
    import repro_torch
    from repro_torch.kernels.bsr_spgemm import bsr_spgemm_local

    t0 = time.perf_counter()
    handle = repro_torch.plan(inst, p=P, model="monoC", seed=0)
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
        exe(a, b)
    torch.cuda.synchronize()
    reset_launches()
    times = []
    for a, b in dev_values[WARMUP:]:
        t0 = time.perf_counter()
        c = exe(a, b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = bsr_spgemm_local.launches["scalar_runs"]
    if launches < REPS:
        fail(f"{inst.name}: {launches} kernel launches in {REPS} calls")
    # check the last call against scipy in float64
    a_np, b_np = values[-1]
    want = (scipy_csr(a_s, a_np) @ scipy_csr(b_s, b_np)).tocsr()
    want.sum_duplicates()
    want.sort_indices()
    if not (np.array_equal(want.indptr, c_s.indptr) and np.array_equal(want.indices, c_s.indices)):
        fail(f"{inst.name}: scipy's product structure differs from the planned C")
    crow, ccol = c_s.coo()
    rows, cols = torch.as_tensor(crow, device=device), torch.as_tensor(ccol, device=device)
    if tuple(c.shape) != c_s.shape or c.device.type != "cuda" or c.dtype != torch.float32:
        fail(f"{inst.name}: result {tuple(c.shape)} {c.dtype} on {c.device}")
    got = c[rows, cols].double()
    ref = torch.from_numpy(want.data).to(device)
    err = (got - ref).abs()
    if not bool(torch.isfinite(c).all()) or not bool((err <= 1e-4 + 1e-4 * ref.abs()).all()):
        fail(f"{inst.name}: wrong product, max abs err {err.max().item()}")
    if int(torch.count_nonzero(c)) != int(torch.count_nonzero(got)):
        fail(f"{inst.name}: nonzeros outside C's structure")
    stats = {
        "instance": inst.name,
        "shape": list(inst.shape),
        "nnz": [a_s.nnz, b_s.nnz, c_s.nnz],
        "n_mult": inst.n_mult,
        "plan_s": round(plan_s, 3),
        "compile_s": round(compile_s, 3),
        "call_ms_median": round(statistics.median(times), 3),
        "call_ms": [round(t, 3) for t in times],
        "launches_per_call": launches / REPS,
        "planned_words": report["planned_words"],
        "predicted_words": report["predicted_words"],
        "padded_words": report["padded_words"],
        "pairs": handle.execution_plan.stats["n_pairs"],
        "pairs_padded": handle.execution_plan.stats["pairs_padded"],
        "max_abs_err": float(err.max().item()),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
    }
    print("main path", json.dumps(stats), flush=True)
    return exe, dev_values[-1], stats


def kernel_record_at(exe, a, b, library_ms):
    """K1's numbers at the shapes the main path gave it: the same inputs
    through the kernel and through its plain version."""
    a_own, b_own = exe.runtime.pack(*exe.pack(a, b))
    args = exe.runtime.step.kernel_inputs(a_own, b_own)
    a_tab, b_tab, pa, pb, pc, rs, rc, n_c = args
    err, ms, plain_ms = check_kernel(args, TOL[str(a_tab.dtype).removeprefix("torch.")])
    bound_ms, bound_by, n_bytes, ops = kernel_bound(a_tab, pa, pb, rs, rc)
    return {
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "bound_bytes": n_bytes,
        "bound_flops": ops,
        "library_ms": library_ms,
        "pairs": pa.numel(),
        "runs": rc.numel(),
        "block": a_tab.shape[-1],
    }


def profile_call(exe, a, b, call_ms: float, calls: int = 3) -> None:
    """Where one front-door call's device time goes: the CUDA kernels that
    ``torch.profiler`` saw over a few calls, per call, against the median
    unprofiled call time ``call_ms`` (the idle share is the rest)."""
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
        return
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / calls
    print(f"profile 27-AP call: call_ms={call_ms:.4f} device_busy_ms={busy_ms:.4f} "
          f"idle_share={1 - busy_ms / call_ms:.3f}", flush=True)
    for e in kernels[:8]:
        print(f"profile   {e.self_device_time_total / 1e3 / calls:.4f} ms "
              f"x{e.count / calls:g} {e.key[:90]}", flush=True)


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
    from repro_torch.kernels.bsr_spgemm import bsr_spgemm_local
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
    launches = bsr_spgemm_local.launches["block_runs"]
    if launches < REPS:
        fail(f"block 16: {launches} kernel launches in {REPS} calls")
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
    k_err, k_ms, k_plain = check_kernel(args, TOL["float32"])
    a_tab, b_tab, pa, pb, pc, rs, rc, n_c = args
    bound_ms, bound_by, n_bytes, ops = kernel_bound(a_tab, pa, pb, rs, rc)
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
    record = {"launches": launches, "max_abs_err": k_err, "ms": k_ms,
              "plain_ms": k_plain, "bound_ms": bound_ms, "bound_by": bound_by,
              "bound_bytes": n_bytes, "bound_flops": ops, "library_ms": library_ms,
              "pairs": pa.numel(), "runs": rc.numel(), "block": block}
    print("block16 path", json.dumps(stats), flush=True)
    print("K1 at block 16", json.dumps(record), flush=True)
    return stats, record


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
    from repro_torch.kernels.bsr_spgemm import bsr_spgemm_local

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
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"ptxas[{name}] {line.strip()}")
    phase("build", t0)

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    cases = {1: (4096, 0.002), 8: (512, 0.02), 16: (256, 0.05), 32: (128, 0.05)}
    for block, (grid, density) in cases.items():
        for dtype in (torch.float32, torch.bfloat16):
            args = random_block_case(rng, grid, block, density, dtype, device)
            name = str(dtype).removeprefix("torch.")
            err, ms, plain_ms = check_kernel(args, TOL[name])
            print(f"K1 check b={block} {name} pairs={args[2].numel()} "
                  f"max_abs_err={err:.3g} ms={ms:.4f} plain_ms={plain_ms:.4f}", flush=True)
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
    profile_call(exe_ap, a_last, b_last, ap_stats["call_ms_median"])
    phase("K1 at the main path's shapes", t0)

    t0 = time.perf_counter()
    block16_stats, blocked = block16_path(device, rng)
    phase("block 16 path", t0)

    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps({
        "card": card_line, "ap": ap_stats, "ptap": ptap_stats, "k1_ap": scalar,
        "block16": block16_stats, "k1_block16": blocked,
    }, indent=1))
    source = "src/repro_torch/kernels/csrc/bsr_spgemm.cu"
    kernels = [
        {"name": f"bsr_spgemm/{name}", "route": "cuda", "source": source,
         "replaces": "src/repro/kernels/bsr_spgemm.py:63",
         **{k: rec[k] for k in ("launches", "max_abs_err", "ms", "plain_ms",
                                "bound_ms", "bound_by", "library_ms")}}
        for name, rec in (("scalar_runs", scalar), ("block_runs", blocked))
    ]
    print(json.dumps({"kernels": kernels}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
