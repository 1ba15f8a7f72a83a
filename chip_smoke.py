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
     squared, against a float64 dense product; then ``scalar_runs`` alone
     at the paper's sizes (``k1_paper_sizes``): MCL-facebook at scale 1
     squared and 27-AP at n = 63, one launch over each whole product's
     pair list, fp32 and bf16, against the plain version and beside CSR @
     CSR (every ``scalar_runs`` check also fills C with NaN, launches
     again, and wants every slot no run covers zero and the same bits);
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
     stage alone bit for bit; the fp32 gradient of the up projection at
     the same width (``moe_gemm_backward``: ``split3_bf16_t`` and two
     ``expert_split``), each launch against its plain version, beside
     ``torch.bmm``; then every route off its tile grid, d and f
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
     retry or failure;
 11. summa2d and the device partitioner: ``model="summa2d"`` through the
     front door on 27-PTAP, LP-pds100 and 27-AP at p = 4 and 27-PTAP at
     p = 6 (closed-form words through the collective, one K1 launch a
     stage, K1 per stage against its plain version, auto's words beside);
     ``engine="device"`` (``coarsen="auto"`` and ``"host"``) planning monoC
     for 27-AP and LP-pds100 (phases, balance, connectivity within 1.25 x
     the flat plans', the product against scipy); the card's partition
     labels against the port's CPU labels; profiles of a 27-AP and an
     LP-pds100 device partition, taken on those runs.
 12. LM serving (``lm_serving``): Qwen3-MoE-235B-A22B at its published
     width, bf16, 4 of its 94 layers: an expert placement planned by
     ``core.moe_planner`` for 4 columns and installed in the config;
     ``make_prefill_step`` on 8 x 1024 synthetic tokens (K3 at C = 640,
     3 launches a layer) and 16 greedy ``make_decode_step`` steps (K3 at
     C = 1), timed and profiled, with the decode step's byte bound; every K3
     launch of one prefill and one decode step against its plain version;
     prefill against token-by-token decode in fp32 at 2 layers; the ten
     smoke configs (attention, Mamba, hybrid), card against CPU.
 13. ranks in processes (``ranks_in_processes``): 4 processes on the one
     card (``launch.ranks.run_ranks``), one rank each, over a gloo group
     that moves the bytes through the host: (a) the seven models and
     summa2d on 27-PTAP and LP-pds100 through ``compile(group=...)``, each
     rank's items against the plan's, C against the one-process result and
     scipy, a call's time, K1 at rank 0's monoC inputs; (b)
     ``compressed_psum_mean`` on 64 M bf16 gradient elements; (c)
     Qwen3-MoE-235B-A22B prefill, 2 x 1024 tokens, 2 layers, with its
     experts split over the ranks, against the one-process prefill; (d)
     LP-pds100 monoC and 27-PTAP fine through ``compile(batch=8,
     group=...)``, a dispatch of 8 sets and a ragged one of 5, against the
     one-process batched result (K1 once a dispatch a rank), beside 8
     looped group calls; (e) phase 10's serving through
     ``SpGEMMServer(group=...)``: 48 requests, a restart on the plan
     store, a fault on rank 1 alone that every rank retries, every
     collective's wait; (f) 16 expert-parallel decode steps after (c)'s
     prefill, against the one-process decode, with a step's host syncs.
 14. training (``training``): (a) Qwen3-MoE-235B-A22B at its published
     width, bf16, 2 of its 94 layers, Adafactor, 4 x 1024 tokens a step
     (K3 at C = 320), 6 steps through ``launch.train.build_trainer`` and
     ``launch.elastic.run_loop`` with activation checkpointing: 12 K3
     launches a MoE layer a step (3 forward, 3 recomputed, 3
     ``expert_wgmma_dx`` and 3 ``expert_wgmma_dw``), step and optimizer
     ms, tokens/s, peak memory under 75 GB, a profile, every K3 launch of
     a step against its plain version (dx and dw by the bf16 rule scaled
     to the gradient's size), the gradient products beside ``torch.bmm``;
     (b) the ten smoke configs' loss, gradients and one step of each
     optimizer, card against CPU, fp32, every K3 launch on the card
     against its plain version; (c) ``launch.train.main`` resumed after an
     injected failure and after a restart (internlm2), and after a
     restart (Qwen3-MoE), against the uninterrupted run.
 15. Mamba and hybrid layers (``ssm``): falcon-mamba-7b (64 layers) and
     hymba-1.5b (32 layers) at their published widths, bf16, random
     weights: (a), (b) prefill (8 x 1,024 and 2 x 4,096 tokens: hymba's
     2,048-slot KV ring rotated) and 16 greedy decode steps, one under the
     sync debug mode, with profiles and the decode step's byte bound; (c)
     training at published widths through ``build_trainer`` and
     ``run_loop`` (falcon-mamba Adafactor, 16 of its 64 layers; hymba
     AdamW, all 32), peak memory under 75 GB; (d) the scan alone at one
     falcon-mamba layer's shape against a float64 recurrence, its gradient
     against float64 autograd, under rules that refuse zeros, a one-step
     shift and a 10% error; (e) prefill against token-by-token decode in
     fp32 at 2 layers, all beside phase 16 (a)'s dry runs.  No kernel of
     K1-K3 lies on this path.
 16. mesh and dry run (``dry_runs``, ``sharded_serving``): (a) the
     multi-pod dry run (``python -m repro_torch.launch.dryrun``, started
     as phase 15 starts, in processes of its own on the host's cores,
     beside phase 15 and collected before (b): a fake
     group of 256 or 512 ranks, fake tensors, no storage) of
     internlm2-1.8b x decode_32k on 16x16 and 2x16x16 and
     qwen3-moe-235b-a22b x train_4k on 16x16 at all 94 layers, and
     internlm2-1.8b x train_4k on 2x16x16 cut to 2 layers, each
     record's per-device bytes beside the card's own memory, its trace
     seconds, FLOPs and collectives, any status but ok failing; (b)
     Qwen3-MoE-235B-A22B at its published width, bf16, 2 layers, on a
     (1, 1) mesh over a one-process NCCL group on the card, parameters
     distributed by ``param_shardings`` (DTensors): a prefill of 2 x 1024
     tokens and 4 greedy decode steps whose logits must equal the
     unsharded steps' bit for bit with K3 launched as often, every K3
     launch of one prefill and decode step against its plain version, and
     the sharded steps' times beside the unsharded ones.
 17. examples (``examples``): the six scripts of ``examples_torch/`` on
     the card: (a) the quickstart on MCL-dip at scale 0.2 (all seven
     models planned, ``auto`` executed), ``auto``'s and monoC's products
     against scipy in float64, K1 on monoC; (b) the model sweep on AMG n=6
     (measured words == predicted, no LRU miss after compile); (c) the AMG
     study, its tables equal to a ``--device cpu`` run; (d) the MoE
     placement's loss (3 K3 products a MoE layer, each against its plain
     version; the CPU's loss within 1e-4); (e) decode (4 x 64 prompts, 32
     tokens) on internlm2-1.8b at full depth and Qwen3-MoE-235B-A22B at 4
     layers (3 K3 launches a layer a step); (f) ``train_100m.py``: 200
     steps (loss finite, step 199 below ln 16,384 and 1 nat under step
     0), then a run stopped after step 120 and resumed from its step-100
     checkpoint, within 1e-5 of the uninterrupted run.
Then one JSON line of per-kernel numbers (one entry per __global__, each
with the launches of the path it is read on: ``scalar_runs`` on the block-1
path, ``warp_runs`` on the block-16 path, ``tile_runs`` and ``mma_runs``
on the retiled 32 and 64 products, ``warp_rows`` and ``mma_rows`` on the
fp32 and bf16 AMG SpMMs at 8 x 8, ``warp_blocks`` and ``mma_blocks`` on
the fp32 and bf16 ones at 12 x 12, ``expert_wgmma``
on the bf16 up projection, ``expert_split`` and ``split3_bf16`` on the
fp32 one, ``stage16`` on the misaligned bf16 up projection, the fp32
gradient's ``split3_bf16_t`` and two ``expert_split`` products at that
width with their launches in phase 8's one backward call, and
``expert_wgmma`` again at the LM path's prefill (C = 640) and decode
(C = 1) up projections, with their launches on that path, and phase 13's
``scalar_runs`` and ``expert_wgmma`` with the launches the ranks counted
in their processes (timed on rank 0 while the others wait), with 13 (d)'s
batched ``scalar_runs`` and 13 (f)'s ``expert_wgmma`` at C = 1, and phase 14's
``expert_wgmma``, ``expert_wgmma_dx`` and ``expert_wgmma_dw`` with their
launches in one training step, and ``split3_bf16_t`` and the backward's
two ``expert_split`` products (dx, dw) with their launches in 14 (b),
timed at (b)'s own operands, and ``expert_wgmma`` with its launches in
phase 16 (b)'s sharded prefill and decode steps, timed at the prefill's
up projection, and phase 17's ``scalar_runs`` on MCL-dip monoC, phase
6's ``scalar_runs`` alone at MCL-facebook and 27-AP n = 63,
``expert_split`` in (d) and ``expert_wgmma`` in (e)'s Qwen3-MoE decode,
each with the launches of its path; bounds at the peak of each route's
arithmetic, ``PEAK_FLOPS``; a time under its bound
fails), the card line, and the result line; the phases' full records go to
``chip_smoke.json`` under ``OUT`` (phase 10 under ``serving``, 11 under
``summa_device``, 12 under ``lm_serve``, 13 under ``ranks``, 14 under
``train``, 15 under ``ssm``, 16 under ``mesh``, 17 under ``examples``,
with ``train_100m.py``'s logs beside it; the dry runs' records
and logs under ``dryrun/``).
Any failure exits non-zero without the result line; there is no CPU
fallback.
"""
from __future__ import annotations

import atexit
import json
import os
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
# phase 9's 1D models on LP-pds100 and 27-AP are timed SLOW_REPS times, not
# REPS: their dense local products take 0.5-0.85 s a call
ONE_D_MODELS, SLOW_REPS = ("rowwise", "columnwise", "outer"), 3


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


def within(got, want, tol: float, scale: float = 1.0) -> tuple[bool, float]:
    """(every element within tol scale + tol |want|, max |got - want|)."""
    err = (got.float() - want.float()).abs()
    return bool((err <= tol * scale + tol * want.float().abs()).all()), float(err.max().item())


def max_err_within(got, want, tol: float, what: str, scale: float = 1.0) -> float:
    """max |got - want|; fails unless every element is within
    tol scale + tol |want|."""
    ok, err = within(got, want, tol, scale)
    if not ok:
        fail(f"{what}: max abs err {err}")
    return err


def grad_scale(want) -> float:
    """min(1, max |want|): the absolute part of ``grad_err_within``'s rule,
    over tol."""
    return min(1.0, float(want.float().abs().max().item()))


def grad_err_within(got, want, tol: float, what: str) -> float:
    """``max_err_within`` with the absolute part scaled to the gradient's
    own size, tol min(1, max|want|) + tol |want| (never looser than tol +
    tol |want|): a loss averaged over thousands of tokens has gradients far
    below 1, where tol + tol |want| would pass a result of zeros."""
    return max_err_within(got, want, tol, what, grad_scale(want))


def rule_rejects(want, tol: float, what: str, scale: float = 1.0, shift=None) -> None:
    """Fails unless the rule tol scale + tol |want| (``within``) refuses
    wrong results for ``want``: zeros, one 10% too large, and, with
    ``shift`` = (name, dim), ``want`` rolled one place along ``dim``."""
    import torch

    bad = {"zeros": torch.zeros_like(want), "10% too large": want.float() * 1.1}
    if shift is not None:
        bad[shift[0]] = want.roll(1, shift[1])
    for name, wrong in bad.items():
        if within(wrong, want, tol, scale)[0]:
            fail(f"{what}: the rule accepts {name}")


def scalar_writes_every_slot(args, got) -> None:
    """``scalar_runs`` into C filled with NaN first: every C slot written,
    zero where no run lands, and the bits of ``got`` (an earlier launch on
    the same inputs)."""
    import torch
    from repro_torch.kernels.bsr_spgemm import launch

    a, b, pa, pb, pc, rs, rc, n_c = args
    out = torch.full_like(got, float("nan"))
    launch(a, b, pa, pb, rs, rc, out)
    torch.cuda.synchronize()
    uncovered = torch.ones(n_c, dtype=torch.bool, device=out.device)
    uncovered[rc.long()] = False
    if out[uncovered].any():  # NaN is not zero
        fail("scalar_runs left a C slot no run covers unwritten or not zero")
    if not torch.equal(out, got):
        fail("two scalar_runs launches on the same inputs differ")


def check_kernel(args, tol: float, garbage_slot: bool = True):
    """K1 against the plain version on the same inputs; returns
    (max_abs_err, the kernel's ms by graph replay, the wrapper's call ms by
    events, plain ms).  With ``garbage_slot`` the last C slot is a padding run's and
    must stay zero."""
    import torch
    from repro_torch.kernels.bsr_spgemm import bsr_spgemm_local, launch, route
    from repro_torch.kernels.ref import bsr_spgemm_ref

    a, b, pa, pb, pc, rs, rc, n_c = args
    got = bsr_spgemm_local(*args)
    want = bsr_spgemm_ref(a, b, pa, pb, pc, n_c)
    torch.cuda.synchronize()
    err = max_err_within(got, want, tol, "K1 disagrees with its plain version")
    if garbage_slot and got[-1].any():
        fail("the garbage C slot is not zero")
    if route(a.shape[1], a.shape[2], b.shape[2]) == "scalar_runs":
        scalar_writes_every_slot(args, got)
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


def front_door_run(inst, model, device, rng, handle=None, reps=REPS):
    """Plan (unless ``handle`` is given), compile and run one model through
    the front door: 1 warm-up call, then ``reps`` timed calls, each ending
    in a synchronize; the collective's items per call must equal the plan's
    (``moved_items``); the last call is checked against scipy in float64.
    Returns (compiled handle, the last call's device values, record)."""
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
        for _ in range(WARMUP + reps)
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
    if comm.items_moved != reps * items:
        fail(f"{what}: the collective moved {comm.items_moved} items in {reps} calls, "
             f"not {reps} x {items}")
    err = check_product(inst, c, *values[WARMUP + reps - 1], device, what)
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
        "items_moved_per_call": comm.items_moved // reps,
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
    return kernel_record(exe.runtime.step.kernel_inputs(a_own, b_own), library_ms)


def kernel_record(args, library_ms, garbage_slot: bool = True):
    """K1's numbers on one launch's arguments (``kernel_record_at``);
    ``garbage_slot`` as ``check_kernel`` takes it."""
    a_tab, b_tab, pa, pb, pc, rs, rc, n_c = args
    err, ms, call_ms, plain_ms = check_kernel(args, TOL[dtype_name(a_tab.dtype)], garbage_slot)
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


# K1 alone at the paper's sizes (no partition: one launch over the whole
# product's pair list): the MCL square with the longest hub runs, and the
# AMG Galerkin product at n = 63, whose 297 MB the kernel must move
K1_PAPER = (("mcl_facebook", "MCL-facebook, scale 1, squared"), ("amg63", "27-AP, n = 63"))


def k1_paper_instance(key: str):
    from repro_torch.core.matrices import amg_instances, mcl_instance

    return mcl_instance("facebook", 1.0) if key == "mcl_facebook" else amg_instances(63)[0]


def k1_paper_inputs(inst, device, rng):
    """``bsr_spgemm_local``'s arguments for ``inst`` at 1 x 1 x 1 (pair
    lists by ``build_pair_lists`` and ``pair_runs``, fp32 N(0, 1) values
    from ``rng``), the values in CSR order, and the runs' lengths."""
    import torch
    from repro_torch.kernels.bsr_spgemm import build_pair_lists, pair_runs

    (ar, ac), (br, bc) = inst.a.coo(), inst.b.coo()
    pa, pb, pc, crows, _ = build_pair_lists(ar, ac, br, bc)
    run_start, run_c = pair_runs(pc)
    a_vals = torch.from_numpy(rng.standard_normal(len(ar)).astype(np.float32)).to(device)
    b_vals = torch.from_numpy(rng.standard_normal(len(br)).astype(np.float32)).to(device)
    t = lambda x: torch.as_tensor(np.asarray(x, np.int32), device=device)  # noqa: E731
    args = (a_vals.view(-1, 1, 1), b_vals.view(-1, 1, 1), t(pa), t(pb), t(pc), t(run_start),
            t(run_c), len(crows))
    return args, (a_vals, b_vals), np.diff(run_start)


def k1_paper_sizes(device, rng) -> dict:
    """K1 ``scalar_runs`` alone at ``K1_PAPER``'s two products: one
    launch through ``bsr_spgemm_local`` with the counts set to 0 just
    before, then ``kernel_record``'s numbers (graph-replay and call ms,
    the plain version within 1e-4, ``kernel_bound``, CSR @ CSR; with
    ``check_kernel``'s NaN-filled launch: every C slot written, the same
    bits twice), the bf16 result within 2e-2 of its plain version, and the
    pairs, runs and their mean and largest length."""
    import torch
    from repro_torch.kernels.bsr_spgemm import bsr_spgemm_local
    from repro_torch.kernels.ref import bsr_spgemm_ref

    records = {}
    for key, label in K1_PAPER:
        t0 = time.perf_counter()
        inst = k1_paper_instance(key)
        args, (a_vals, b_vals), lengths = k1_paper_inputs(inst, device, rng)
        host_s = time.perf_counter() - t0
        reset_launches()
        bsr_spgemm_local(*args)
        torch.cuda.synchronize()
        launches = bsr_spgemm_local.launches["scalar_runs"]
        library_ms = library_csr_ms(csr_on_card(inst.a, a_vals, device),
                                    csr_on_card(inst.b, b_vals, device))
        rec = kernel_record(args, library_ms, garbage_slot=False)  # no padding run
        a16, b16 = args[0].bfloat16(), args[1].bfloat16()
        got16 = bsr_spgemm_local(a16, b16, *args[2:])
        rec["bf16_max_abs_err"] = max_err_within(
            got16, bsr_spgemm_ref(a16, b16, *args[2:5], args[7]), TOL["bfloat16"],
            f"K1 {label} in bf16")
        rec.update(instance=label, launches=launches, mean_run=float(lengths.mean()),
                   max_run=int(lengths.max()), host_s=host_s)
        records[key] = rec
        print(f"K1 at {label}", json.dumps(rec), flush=True)
        del args, got16, a16, b16
        torch.cuda.empty_cache()
    return records


def profile_call(exe, a, b, call_ms: float, calls: int = 3, label: str = "27-AP") -> dict:
    """Where one front-door call's device time goes (``profile_fn`` of
    ``exe(a, b)``)."""
    return profile_fn(lambda: exe(a, b), call_ms, calls, label)


def profile_fn(fn, call_ms: float, calls: int = 3, label: str = "27-AP") -> dict:
    """Where one call of ``fn``'s device time goes: the CUDA kernels that
    ``torch.profiler`` saw over a few calls, per call, against the median
    unprofiled call time ``call_ms`` (the idle share is the rest).  Printed,
    and returned for the phase's record (empty if the profiler saw no
    device time).  It traces the card's activity alone: host op events
    would add nothing it reads, and cost seconds in calls of a hundred
    thousand launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
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
            "idle_share": 1 - busy_ms / call_ms, "kernels": top,
            "profile_s": time.perf_counter() - t0}


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
    from repro_torch.kernels.moe_gemm import (
        launch_plan,
        moe_gemm,
        moe_gemm_backward,
        split3_bf16,
        stage16,
    )
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
    # the fp32 gradient at the up projection's shapes (phase 14 (b) times it
    # only at its smoke shapes, where every launch waits on the host): one
    # moe_gemm_backward call, then each launch checked and timed as there
    dy32 = normal((E, C, f), 1e-3, torch.float32)
    reset_launches()
    moe_gemm_backward(x32, w32, dy32)
    torch.cuda.synchronize()
    launches = {k: v for k, v in moe_gemm.launches.items() if v}
    if launches != {"split3_bf16": 1, "split3_bf16_t": 2, "expert_split": 2}:
        fail(f"K3: launches {launches} in one fp32 moe_gemm_backward call")
    records["grad_fp32"] = k3_split_grad_records(
        x32, w32, dy32, {"split3_bf16_t": launches["split3_bf16_t"], "backward_calls": 1})
    for name, r in records["grad_fp32"].items():
        print(f"K3 fp32 gradient {name}", json.dumps(r), flush=True)
    del dy32
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
    handles = {}  # (instance, model) -> planned handle, for phase 13

    def run(inst, model, handle=None):
        t0 = time.perf_counter()
        # LP-pds100 and 27-AP (and auto where it picks a 1D model)
        slow = inst is not ptap and (model if handle is None else handle.model) in ONE_D_MODELS
        exe, last, rec = front_door_run(inst, model, device, rng, handle,
                                        reps=SLOW_REPS if slow else REPS)
        rec["seconds"] = round(time.perf_counter() - t0, 3)
        key = "auto" if handle is not None else model
        records.setdefault(inst.name, {})[key] = rec
        if handle is None:
            handles[(inst, model)] = exe.planned
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
    for model in ONE_D_MODELS:
        exe, (a, b), rec = run(ap, model)
        if model in ("rowwise", "outer"):
            rec["profile"] = profile_call(exe, a, b, rec["call_ms_median"], calls=2,
                                          label=f"27-AP {model}")
            torch.cuda.empty_cache()
    phase("every model (c) 27-AP, 1D", t0)
    return records, lp, {k: h for k, h in handles.items() if k[0] is not ap}


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


def summa_stage_kernels(exe, a, b) -> dict:
    """K1 on each stage of a summa2d call: the stage's own inputs through the
    kernel (graph replay) and its plain version, summed over the stages."""
    a_own, b_own = exe.runtime.pack(*exe.pack(a, b))
    step = exe.runtime.step
    out = {"ms": 0.0, "call_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0,
           "pairs": 0, "stages": []}
    for t in range(step.n_stages):
        args = step.kernel_inputs(a_own, b_own, t)
        a_tab, b_tab, pa, pb, pc, rs, rc, n_c = args
        err, ms, call_ms, plain_ms = check_kernel(args, TOL[dtype_name(a_tab.dtype)])
        bound_ms, bound_by, *_ = kernel_bound(a_tab, b_tab, pa, pb, rs, rc)
        out["stages"].append({"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                              "bound_by": bound_by, "pairs": pa.numel(), "runs": rc.numel()})
        for key, v in (("ms", ms), ("call_ms", call_ms), ("plain_ms", plain_ms),
                       ("bound_ms", bound_ms)):
            out[key] += v
        out["max_abs_err"] = max(out["max_abs_err"], err)
        out["pairs"] += pa.numel()
        del args, a_tab, b_tab
    return out


def device_profile(label: str, run, partition_of=lambda out: out):
    """``run()`` — a call that makes one ``engine="device"`` partition —
    under ``torch.profiler``, with the card's sync debug mode warning on
    every host sync.  Returns ``(run(), record)``: the top device ops, the
    device's idle share over the partition (its three phases) and over its
    device phases (the ascent, and the descend where it ran on the card),
    the host syncs by source line and per level, and the levels of the
    descend (``coarsen_device.coarsen_level`` calls that coarsened, or the
    host V-cycle's levels).  ``partition_of(run())`` is the
    ``PartitionResult``; the profile spans the whole call, so device ops
    outside the partition would count as busy."""
    import importlib

    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import coarsen_device

    partition_mod = importlib.import_module("repro_torch.core.partition")

    descended, host_levels = [], []
    coarsen_level, global_vcycle = coarsen_device.coarsen_level, partition_mod._global_vcycle

    def counted(*args, **kwargs):  # the levels the resident descent makes
        out = coarsen_level(*args, **kwargs)
        descended.append(out is not None)
        return out

    def counted_vcycle(*args, **kwargs):  # the host descend's levels
        levels, cur = global_vcycle(*args, **kwargs)
        host_levels.append(len(levels))
        return levels, cur

    coarsen_device.coarsen_level = counted
    partition_mod._global_vcycle = counted_vcycle
    torch.cuda.synchronize()
    try:
        with warnings.catch_warnings(record=True) as caught, \
                profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            torch.cuda.set_sync_debug_mode("default")
    finally:
        coarsen_device.coarsen_level = coarsen_level
        partition_mod._global_vcycle = global_vcycle
        torch.cuda.set_sync_debug_mode("default")
    res = partition_of(out)
    if res.phases is None:
        fail(f"device profile {label}: no device phases: the device engine did not run")
    syncs = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            where = f"{Path(w.filename).name}:{w.lineno}"
            syncs[where] = syncs.get(where, 0) + 1
    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    ops.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_s = sum(e.self_device_time_total for e in ops) / 1e6
    partition_s = sum(res.phases.values())
    device_s = res.phases["refine_s"] + (res.phases["coarsen_s"] if res.descend == "device" else 0)
    levels = 1 + (sum(descended) if res.descend == "device" else sum(host_levels))
    rec = {
        "label": label, "descend": res.descend, "wall_s": wall_s, "partition_s": partition_s,
        "phases": res.phases, "connectivity": res.connectivity, "device_busy_s": busy_s,
        "idle_share": 1 - busy_s / partition_s if ops else None,
        "idle_share_device_phases": 1 - busy_s / device_s if ops else None,
        "levels": levels, "coarsen_calls": len(descended),
        "host_syncs": sum(syncs.values()), "host_syncs_per_level": sum(syncs.values()) / levels,
        "host_syncs_by_line": syncs,
        "top_ops": [{"ms": e.self_device_time_total / 1e3, "count": e.count, "op": e.key[:90]}
                    for e in ops[:10]],
    }
    if not ops:
        print("profile: the profiler saw no device time (not measured)", flush=True)
    print(f"device profile {label}", json.dumps(rec), flush=True)
    return out, rec


def summa_and_device_engine(ap, ptap, lp, ap_stats, ptap_stats, models, device, rng):
    """Phase 11: the Sparse SUMMA baseline and the device partitioner.

    (a) ``model="summa2d"`` through the front door (as ``front_door_run``)
    on 27-PTAP, LP-pds100 and 27-AP at p = 4 and 27-PTAP at p = 6, each on
    the grid ``summa_mesh_shape`` picks: the collective's items a call ==
    ``moved_items`` == nnz(A)(pc - 1) + nnz(B)(pr - 1), K1 launches a call
    == the stages with pairs, K1 on each stage's own inputs against its
    plain version, and auto's predicted words beside summa2d's.  (b)
    ``engine="device"`` with ``coarsen="auto"`` and ``"host"`` on monoC at
    p = 4 for 27-AP and LP-pds100: plan seconds, phases and the descend
    taken; a result without phases, a part over its cap, or connectivity
    past 1.25 x the flat engine's plan of phases 4 and 9 (the aggregate
    bound of ``tests/test_partition_device.py``) fails.  On these instances
    the finest level is past the reference's int32 sort-key guard
    (``nb * pb < 2^31``), so ``"auto"`` takes the host descend, and its
    labels must equal the ``"host"`` run's.  The product against scipy as
    in (a).  (c) The card's labels equal the port's CPU labels bit for
    bit: 27-PTAP monoC (the host descend, past the guard) and LP-pds100
    rowwise (the resident descent through ``coarsen_device``).  (d)
    ``device_profile`` of (b)'s 27-AP ``"auto"`` plan and of (c)'s
    LP-pds100 rowwise partition on the card, taken on those runs."""
    import torch
    import repro_torch
    from repro_torch.core import build_model
    from repro_torch.core.partition import partition
    from repro_torch.distributed.plan_ir import moved_items
    from repro_torch.kernels.bsr_spgemm import bsr_spgemm_local

    record = {"summa2d": [], "device_engine": [], "labels": [], "profile": {}}
    # auto's predicted words: its rule is the minimum over the models that
    # lower; 27-AP planned four of the seven in phases 4 and 9
    planned = {name: {m: r["predicted_words"] for m, r in recs.items() if m != "auto"}
               for name, recs in models.items()}
    planned.setdefault(ap.name, {})["monoC"] = ap_stats["predicted_words"]
    planned[ptap.name]["monoC"] = ptap_stats["predicted_words"]
    monoC_ms = {ap.name: ap_stats["call_ms_median"], ptap.name: ptap_stats["call_ms_median"],
                lp.name: models[lp.name]["monoC"]["call_ms_median"]}

    t0 = time.perf_counter()
    for inst, p in ((ptap, 4), (lp, 4), (ap, 4), (ptap, 6)):
        t1 = time.perf_counter()
        handle = repro_torch.plan(inst, p=p, model="summa2d")
        plan_s = time.perf_counter() - t1
        plan = handle.execution_plan
        exe, (a, b), rec = front_door_run(inst, "summa2d", device, rng, handle=handle)
        what = f"summa2d {inst.name} p={p}"
        closed = inst.a.nnz * (plan.pc - 1) + inst.b.nnz * (plan.pr - 1)
        if moved_items(plan) != closed or rec["items_moved_per_call"] != closed:
            fail(f"{what}: {rec['items_moved_per_call']} items a call, closed form {closed}")
        staged = sum(int((plan.compute[f"pair_c_s{t}"] != plan.n_c_slots - 1).any())
                     for t in range(plan.n_stages))
        launches = rec["kernel_launches"]
        if launches != {"scalar_runs": REPS * staged} or staged != plan.n_stages:
            fail(f"{what}: K1 launches {launches} in {REPS} calls, {plan.n_stages} stages")
        k1 = summa_stage_kernels(exe, a, b)
        auto_words = min(planned[inst.name].values())
        rec.update(p=p, grid=[plan.pr, plan.pc], n_stages=plan.n_stages, plan_s=plan_s,
                   closed_form_words=closed, k1_launches_per_call=launches["scalar_runs"] / REPS,
                   k1=k1, monoC_call_ms_median=monoC_ms[inst.name],
                   auto_predicted_words=auto_words,
                   auto_over=sorted(planned[inst.name]))
        record["summa2d"].append(rec)
        print(f"summa2d {inst.name} p={p}", json.dumps(rec), flush=True)
        del exe, a, b
        torch.cuda.empty_cache()
    phase("summa2d (a)", t0)

    t0 = time.perf_counter()
    flat = {ap.name: ap_stats["predicted_words"], lp.name: planned[lp.name]["monoC"]}
    handles = {}
    for inst in (ap, lp):
        for coarsen in ("auto", "host"):
            what = f"device engine {inst.name} coarsen={coarsen}"

            def run():
                return repro_torch.plan(inst, p=P, model="monoC", engine="device",
                                        coarsen=coarsen, seed=0)

            t1 = time.perf_counter()
            if inst is ap and coarsen == "auto":  # (d): this run under the profiler
                handle, record["profile"]["27-AP monoC"] = device_profile(
                    f"{ap.name} monoC", run, lambda h: h.partition)
            else:
                handle = run()
            plan_s = time.perf_counter() - t1
            res, hg = handle.partition, handle.hypergraph
            if res.phases is None:
                fail(f"{what}: no device phases: the device engine did not run")
            w = hg.w_comp.astype(np.float64)
            cap = max(1.10 * w.sum() / P, float(w.max()))
            part_w = np.bincount(res.parts, weights=w, minlength=P)
            if part_w.max() > cap + 1e-9:
                fail(f"{what}: part weights {part_w.tolist()} over the cap {cap}")
            ratio = res.connectivity / flat[inst.name]
            if ratio > 1.25:
                fail(f"{what}: connectivity {res.connectivity}, {ratio:.3f} x flat's")
            _, _, rec = front_door_run(inst, "monoC", device, rng, handle=handle)
            rec.update(coarsen=coarsen, descend=res.descend, plan_s=plan_s,
                       profiled=inst is ap and coarsen == "auto", phases=res.phases,
                       connectivity=res.connectivity, flat_connectivity=flat[inst.name],
                       over_flat=ratio, part_weights=part_w.tolist(), cap=cap,
                       n_vertices=hg.n_vertices, n_pins=hg.n_pins)
            record["device_engine"].append(rec)
            print(f"device engine {inst.name} coarsen={coarsen}", json.dumps(rec), flush=True)
            handles[(inst.name, coarsen)] = handle
            torch.cuda.empty_cache()
        auto, host = handles[(inst.name, "auto")].partition, handles[(inst.name, "host")].partition
        if auto.descend == "host" and not np.array_equal(auto.parts, host.parts):
            fail(f"device engine {inst.name}: auto took the host descend, labels differ")
    phase("device engine (b)", t0)

    t0 = time.perf_counter()
    lp_rowwise = build_model(lp, "rowwise")
    cases = ((ptap, "monoC", build_model(ptap, "monoC")), (lp, "rowwise", lp_rowwise))
    for inst, model, hg in cases:
        runs = {}
        for where in ("cuda", "cpu"):
            def run(where=where, hg=hg):
                return partition(hg, P, eps=0.10, seed=0, engine="device",
                                 device=None if where == "cuda" else "cpu")

            t1 = time.perf_counter()
            if inst is lp and where == "cuda":  # (d): this run under the profiler
                runs[where], record["profile"]["LP-pds100 rowwise"] = device_profile(
                    f"{lp.name} rowwise", run)
            else:
                runs[where] = run()
            runs[where + "_s"] = time.perf_counter() - t1
        equal = bool(np.array_equal(runs["cuda"].parts, runs["cpu"].parts))
        rec = {"instance": inst.name, "model": model, "n_vertices": hg.n_vertices,
               "n_pins": hg.n_pins, "labels_equal": equal, "descend": runs["cuda"].descend,
               "card_s": runs["cuda_s"], "cpu_s": runs["cpu_s"],
               "card_phases": runs["cuda"].phases, "cpu_phases": runs["cpu"].phases,
               "connectivity": runs["cuda"].connectivity}
        record["labels"].append(rec)
        print("device engine labels", json.dumps(rec), flush=True)
        if not equal or runs["cuda"].phases is None:
            fail(f"device engine {inst.name} {model}: the card's labels differ from the CPU's")
    phase("device engine labels (c)", t0)
    return record


LM_ARCH = "qwen3-moe-235b-a22b"
LM_LAYERS = 4  # of the published 94: the weights then take 22.4 GB of the card
LM_BATCH, LM_PROMPT, LM_DECODE_STEPS = 8, 1024, 16
LM_PEAK_BYTES = 40e9


def _tree_to(tree, device):
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def _tree_bytes(tree) -> int:
    return sum(_tree_bytes(v) if isinstance(v, dict) else v.numel() * v.element_size()
               for v in tree.values())


def timed_ms(fn, calls: int) -> list[float]:
    """Host-clock ms of ``calls`` calls of ``fn``, each ending in a sync."""
    import torch

    out = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def k3_checked(records: list, keep: dict, label: str, moe_gemm):
    """A stand-in for ``kernels.moe_gemm.moe_gemm`` (what the MoE layer's
    ``GroupedGemm`` calls), around the real ``moe_gemm``, that holds every
    launch against ``moe_gemm_ref`` on the same inputs (bf16 tolerance),
    records its shapes, launches and error, and keeps the first call's
    operands under ``keep[label]``."""
    import torch
    from repro_torch.kernels.ref import moe_gemm_ref

    def checked(x, w, b_c=128, b_f=128, b_d=512):
        before = dict(moe_gemm.launches)
        out = moe_gemm(x, w, b_c, b_f, b_d)
        torch.cuda.synchronize()
        moved = {k: v - before[k] for k, v in moe_gemm.launches.items() if v != before[k]}
        err = max_err_within(out, moe_gemm_ref(x, w), TOL[dtype_name(x.dtype)],
                             f"LM {label}: K3 at {tuple(x.shape)} x {tuple(w.shape)}")
        records.append({"call": label, "x": list(x.shape), "w": list(w.shape),
                        "launches": moved, "max_abs_err": err})
        keep.setdefault(label, (x, w))
        return out

    return checked


def k3_record_at(x, w, launches: int, err: float) -> dict:
    """K3's numbers at operands the LM path gave it: the kernel, its plain
    version and ``torch.bmm`` on the same tensors, by events; the bound is
    each operand read once and the output written once, against the
    route's operations at the tensor cores' peak (bf16, or the split
    products' for fp32)."""
    import torch
    from repro_torch.kernels.moe_gemm import moe_gemm, route
    from repro_torch.kernels.ref import moe_gemm_ref

    E, C, d = x.shape
    f = w.shape[2]
    n_bytes = (x.numel() + w.numel() + E * C * f) * x.element_size()
    n_ops = 2.0 * E * C * d * f
    kernel = route(x, w)
    peak = "float32_split" if kernel == "expert_split" else dtype_name(x.dtype)
    bound_ms, bound_by = bound(n_bytes, n_ops, peak)
    return {
        "kernel": kernel, "shape": [list(x.shape), list(w.shape)], "launches": launches,
        "max_abs_err": err,
        "ms": cuda_ms(lambda: moe_gemm(x, w, b_c=C, b_f=f, b_d=d), reps=20),
        "plain_ms": cuda_ms(lambda: moe_gemm_ref(x, w), reps=3, warmup=1),
        "bound_ms": bound_ms, "bound_by": bound_by, "bound_bytes": n_bytes,
        "bound_flops": n_ops, "library_ms": cuda_ms(lambda: torch.bmm(x, w), reps=20),
        "library_call": "torch.bmm",
    }


def replay_decode(decode, params, cache: dict, tok) -> None:
    """``LM_DECODE_STEPS`` greedy steps from a copy of ``cache``."""
    cache = {k: v.clone() for k, v in cache.items()}
    for _ in range(LM_DECODE_STEPS):
        logits, cache = decode(params, cache, tok)
        tok = logits.argmax(-1)[:, None]


def experts_with_rows(run, n_layers: int) -> list[list[int]]:
    """Runs ``run`` with the MoE layer's K3 calls watched and returns, for
    each decode step and layer, how many experts K3 got a row for: the
    experts whose rows of the up projection's input are not all zero (an
    expert that no kept pair reached has only zero rows)."""
    import torch
    import repro_torch.kernels.moe_gemm as k3

    real, counts = k3.moe_gemm, []

    def watched(x, w, *args, **tiles):
        if len(counts) % 3 == 0:  # up, gate, down: the first of a layer's three
            counts.append((x != 0).flatten(1).any(1).sum())
        else:
            counts.append(None)
        return real(x, w, *args, **tiles)

    try:
        k3.moe_gemm = watched
        run()
    finally:
        k3.moe_gemm = real
    torch.cuda.synchronize()
    per_layer = [int(c) for c in counts if c is not None]
    return [per_layer[i:i + n_layers] for i in range(0, len(per_layer), n_layers)]


def lm_serving(device):
    """Phase 12: the LM stack's serving path with Qwen3-MoE-235B-A22B at its
    published width (d 4096, 64 heads, 4 KV heads, head 128, 128 experts,
    top-8, expert f 1536, vocab 151,936), bf16, ``n_layers`` cut from 94 to
    ``LM_LAYERS``, random weights from a seed.

    (a) ``plan_expert_placement`` for 4 expert columns on correlated
        routing (8192 tokens, 4 blocks of 32 experts scattered over the
        ids, 64 token groups), installed in the config;
    (b) ``make_prefill_step`` on 8 x 1024 tokens of ``SyntheticTokens``
        (T = 8192, C = 640 rows per expert): median ms of 5 calls after a
        warm-up, K3 launches of one call (3 a layer, or it fails), a
        profile (top device ops, idle share);
    (c) ``make_decode_step``, 16 greedy steps on the returned cache (C = 1):
        ms per step, tokens/s, K3 launches (3 a layer a step), one step
        under ``torch.cuda.set_sync_debug_mode("error")`` (no host sync),
        a profile, the step's byte bound (every weight read once), and,
        from a replay of the 16 steps, the experts each layer routes a row
        to and the needed-bytes bound (the weights less the experts that
        got no row);
    (d) every K3 launch of one prefill call and one decode step against
        ``moe_gemm_ref`` on the same inputs (bf16 tolerance), then K3 timed
        at the layer-0 up projection of each, beside its plain version and
        ``torch.bmm``;
    (e) prefill against token-by-token decode at full width in fp32, 2
        layers, B = 1, S = 64, capacity factor E / K (no expert drops a
        pair, so both see the same experts), within 1e-3;
    (f) the ten smoke configs (attention, Mamba and hybrid layers) in
        fp32: ``forward``, ``prefill_step`` and three ``decode_step``s on
        the card against the CPU, same weights, every cache entry too,
        within 1e-4.
    Peak memory over (a)-(d) must stay under 40 GB."""
    import dataclasses

    import torch
    from repro_torch.configs import all_arch_ids, get_config, get_smoke_config
    from repro_torch.core.moe_planner import plan_expert_placement, routing_counts
    import repro_torch.kernels.moe_gemm as k3_mod
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels.moe_gemm import moe_gemm
    from repro_torch.models import forward, init_kv_cache, init_params
    from repro_torch.training import make_decode_step, make_prefill_step

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = get_config(LM_ARCH)
    E, K = base.moe.n_experts, base.moe.top_k
    rec = {"config": LM_ARCH, "n_layers": LM_LAYERS, "n_layers_published": base.n_layers,
           "dtype": base.dtype}

    # (a) the dispatch planner's expert placement
    rng = np.random.default_rng(0)
    n_tokens, n_blocks = 8192, 4
    scattered = rng.permutation(E).reshape(n_blocks, E // n_blocks)
    gate = np.stack([rng.choice(scattered[(t * n_blocks) // n_tokens], size=K, replace=False)
                     for t in range(n_tokens)])
    t_plan = time.perf_counter()
    plan = plan_expert_placement(routing_counts(gate, E, n_groups=64), n_columns=4)
    plan_s = time.perf_counter() - t_plan
    if sorted(plan.placement.tolist()) != list(range(E)):
        fail("LM (a): the placement is not a permutation of the experts")
    if not plan.comm_planned < plan.comm_contiguous:
        fail(f"LM (a): planned cut {plan.comm_planned} not below contiguous {plan.comm_contiguous}")
    rec["placement"] = {
        "plan_s": plan_s, "columns": 4, "tokens": n_tokens, "groups": 64,
        "comm_planned": int(plan.comm_planned), "comm_contiguous": int(plan.comm_contiguous),
        "load_imbalance_planned": plan.load_imbalance_planned,
        "load_imbalance_contiguous": plan.load_imbalance_contiguous,
    }
    print("LM (a) placement", json.dumps(rec["placement"]), flush=True)
    cfg = dataclasses.replace(base, n_layers=LM_LAYERS, moe=dataclasses.replace(
        base.moe, expert_placement=tuple(int(e) for e in plan.placement)))
    phase("LM serving (a) placement", t0)

    # (b) prefill
    t_init = time.perf_counter()
    params = init_params(cfg, 0, device=device)
    torch.cuda.synchronize()
    rec["init_s"] = time.perf_counter() - t_init
    rec["param_bytes"] = _tree_bytes(params)
    tokens = torch.as_tensor(
        SyntheticTokens(cfg.vocab, LM_PROMPT, LM_BATCH, seed=0).batch(0)["tokens"], device=device)
    batch = {"tokens": tokens}
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    prefill(params, batch)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    logits, cache = prefill(params, batch)
    torch.cuda.synchronize()
    launches = {k: v for k, v in moe_gemm.launches.items() if v}
    if launches != {"expert_wgmma": 3 * LM_LAYERS}:
        fail(f"LM (b): K3 launches {launches} in one prefill call, not "
             f"{{'expert_wgmma': {3 * LM_LAYERS}}}")
    if logits.shape != (LM_BATCH, cfg.vocab) or not bool(logits.isfinite().all()):
        fail(f"LM (b): prefill logits {tuple(logits.shape)}, finite {bool(logits.isfinite().all())}")
    prefill_launches = launches["expert_wgmma"]
    calls = timed_ms(lambda: prefill(params, batch), 5)
    cap = int(np.ceil(LM_BATCH * LM_PROMPT * K / E * cfg.moe.capacity_factor))
    rec["prefill"] = {
        "batch": LM_BATCH, "prompt": LM_PROMPT, "tokens": LM_BATCH * LM_PROMPT, "capacity": cap,
        "ms_median": statistics.median(calls), "ms": calls,
        "tokens_per_s": LM_BATCH * LM_PROMPT / (statistics.median(calls) / 1e3),
        "k3_launches_per_call": launches,
    }
    rec["prefill"]["profile"] = profile_fn(lambda: prefill(params, batch),
                                           rec["prefill"]["ms_median"], calls=2,
                                           label="LM prefill")
    print("LM (b) prefill", json.dumps(rec["prefill"]), flush=True)
    phase("LM serving (b) prefill", t0)

    # (c) greedy decode on the returned cache
    logits, cache = prefill(params, batch)
    tok = logits.argmax(-1)[:, None]
    start = ({k: v.clone() for k, v in cache.items()}, tok)  # replayed below
    steps = []
    reset_launches()
    for _ in range(LM_DECODE_STEPS):
        t_step = time.perf_counter()
        logits, cache = decode(params, cache, tok)
        tok = logits.argmax(-1)[:, None]
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t_step) * 1e3)
    launches = {k: v for k, v in moe_gemm.launches.items() if v}
    if launches != {"expert_wgmma": 3 * LM_LAYERS * LM_DECODE_STEPS}:
        fail(f"LM (c): K3 launches {launches} in {LM_DECODE_STEPS} decode steps")
    if not bool(logits.isfinite().all()) or int(cache["pos"]) != LM_PROMPT + LM_DECODE_STEPS:
        fail(f"LM (c): decode logits finite {bool(logits.isfinite().all())}, "
             f"pos {int(cache['pos'])}")
    decode_launches = launches["expert_wgmma"]
    torch.cuda.set_sync_debug_mode("error")  # a step must never wait for the card
    try:
        decode(params, cache, tok)
    except RuntimeError as e:
        fail(f"LM (c): a decode step waits for the card: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    hit = experts_with_rows(lambda: replay_decode(decode, params, *start), LM_LAYERS)
    table = params["embed"]["tokens"]
    # every weight read once; of the embedding table, the B rows gathered
    step_bytes = (rec["param_bytes"] - table.numel() * table.element_size()
                  + LM_BATCH * cfg.d_model * table.element_size())
    # the same, less the experts that no token reached (K3 still reads them)
    one_expert = sum(params["layers"]["moe"][k][0, 0].numel() for k in ("wi", "wg", "wo")) * (
        table.element_size())
    needed = [step_bytes - sum(E - n for n in step) * one_expert for step in hit]
    step_ms = statistics.median(steps)
    rec["decode"] = {
        "batch": LM_BATCH, "steps": LM_DECODE_STEPS, "capacity": int(np.ceil(
            LM_BATCH * K / E * cfg.moe.capacity_factor)),
        "ms_per_step_median": step_ms, "ms": steps, "tokens_per_s": LM_BATCH / (step_ms / 1e3),
        "k3_launches_per_step": {k: v / LM_DECODE_STEPS for k, v in launches.items()},
        "bound_bytes": step_bytes, "bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3,
        "experts_with_rows": hit, "experts_with_rows_mean": float(np.mean(hit)),
        "needed_bytes_median": statistics.median(needed),
        "needed_ms_median": statistics.median(needed) / HBM_BYTES_PER_S * 1e3,
    }
    rec["decode"]["profile"] = profile_fn(lambda: decode(params, cache, tok), step_ms, calls=3,
                                          label="LM decode step")
    print("LM (c) decode", json.dumps(rec["decode"]), flush=True)
    phase("LM serving (c) decode", t0)

    # (d) every K3 launch of one prefill call and one decode step
    checks, operands = [], {}
    real = k3_mod.moe_gemm
    try:
        k3_mod.moe_gemm = k3_checked(checks, operands, "prefill", real)
        logits, cache = prefill(params, batch)
        k3_mod.moe_gemm = k3_checked(checks, operands, "decode", real)
        decode(params, cache, logits.argmax(-1)[:, None])
    finally:
        k3_mod.moe_gemm = real
    for label in ("prefill", "decode"):
        mine = [c for c in checks if c["call"] == label]
        if len(mine) != 3 * LM_LAYERS or any(c["launches"] != {"expert_wgmma": 1} for c in mine):
            fail(f"LM (d): {label} K3 calls {[(c['x'], c['launches']) for c in mine]}")
    rec["k3_checks"] = checks
    k3 = {}
    for label, launches in (("prefill", prefill_launches), ("decode", decode_launches)):
        err = max(c["max_abs_err"] for c in checks if c["call"] == label)
        k3[label] = k3_record_at(*operands[label], launches, err)
        print(f"LM (d) K3 {label}", json.dumps(k3[label]), flush=True)
    rec["k3"] = k3
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    if rec["peak_bytes"] > LM_PEAK_BYTES:
        fail(f"LM: peak memory {rec['peak_bytes'] / 1e9:.2f} GB over {LM_PEAK_BYTES / 1e9:.0f} GB")
    del params, cache, logits, operands, batch, tokens, start
    torch.cuda.empty_cache()
    phase("LM serving (d) K3 checks", t0)

    # (e) prefill against token-by-token decode, fp32, full width, 2 layers
    torch.cuda.reset_peak_memory_stats()
    cfg32 = dataclasses.replace(cfg, n_layers=2, dtype="float32", moe=dataclasses.replace(
        cfg.moe, capacity_factor=E / K))
    params = init_params(cfg32, 1, device=device)
    toks = torch.as_tensor(SyntheticTokens(cfg.vocab, 64, 1, seed=1).batch(0)["tokens"],
                           device=device)
    want, _ = make_prefill_step(cfg32)(params, {"tokens": toks})
    cache = init_kv_cache(cfg32, 1, 64, device=device)
    decode32 = make_decode_step(cfg32)
    for i in range(64):
        got, cache = decode32(params, cache, toks[:, i:i + 1])
    rec["prefill_vs_decode"] = {
        "n_layers": 2, "dtype": "float32", "batch": 1, "seq": 64,
        "capacity_factor": E / K, "tol": 1e-3,
        "max_abs_err": max_err_within(got, want, 1e-3, "LM (e): prefill against decode"),
        "peak_bytes": torch.cuda.max_memory_allocated(),
    }
    print("LM (e) prefill vs decode", json.dumps(rec["prefill_vs_decode"]), flush=True)
    del params, cache
    torch.cuda.empty_cache()
    phase("LM serving (e) prefill vs decode", t0)

    # (f) the ten smoke configs (attention, Mamba, hybrid), card against CPU
    rec["card_vs_cpu"] = {}
    for arch in all_arch_ids():
        scfg = get_smoke_config(arch)
        cpu_params = init_params(scfg, 0, device="cpu")
        card_params = _tree_to(cpu_params, device)
        rng = np.random.default_rng(0)
        n_front = 16 if scfg.frontend == "vision" else 0
        b = {"tokens": rng.integers(0, scfg.vocab, (2, 64 - n_front)).astype(np.int32)}
        if n_front:
            b["frontend_embeds"] = rng.standard_normal((2, n_front, scfg.d_model)).astype(
                np.float32)
        errs = [max_err_within(g.cpu(), w, TOL["float32"], f"LM (f) {arch} forward")
                for g, w in zip(forward(card_params, scfg, b), forward(cpu_params, scfg, b))]
        pre, dec = make_prefill_step(scfg), make_decode_step(scfg)
        (lg, ch), (lw, cw) = pre(card_params, b), pre(cpu_params, b)
        errs.append(max_err_within(lg.cpu(), lw, TOL["float32"], f"LM (f) {arch} prefill"))
        for step in range(3):
            t = lw.argmax(-1)[:, None]
            (lg, ch), (lw, cw) = dec(card_params, ch, t), dec(cpu_params, cw, t)
            errs.append(max_err_within(lg.cpu(), lw, TOL["float32"], f"LM (f) {arch} decode"))
        errs += [max_err_within(ch[k].cpu(), cw[k], TOL["float32"], f"LM (f) {arch} cache {k}")
                 for k in cw]
        rec["card_vs_cpu"][arch] = max(errs)
    print("LM (f) card vs CPU", json.dumps(rec["card_vs_cpu"]), flush=True)
    phase("LM serving (f) card vs CPU", t0)
    rec["phase_s"] = time.perf_counter() - t0
    return rec


RANKS = 4  # phase 13: one rank a process, every process on the one card
RANK_REPS = 3
# 13 (a)'s products timed once: the 1D models' dense local products on
# LP-pds100 take 0.8-1.6 s a call over the group
RANK_SLOW_PRODUCTS = ("LP-pds100/rowwise", "LP-pds100/columnwise", "LP-pds100/outer")
EP_LAYERS, EP_BATCH, EP_PROMPT = 2, 2, 1024  # phase 13 (c): 2 of the published 94 layers
EP_DECODE_STEPS = 16  # phase 13 (f), after (c)'s prefill
GRAD_ELEMS = 64 * 2**20  # phase 13 (b)
BATCH_SETS, RAGGED_SETS = 8, 5  # phase 13 (d): a full dispatch and a ragged one
BATCHED = (("LP-pds100", "monoC"), ("27-PTAP(n=42)", "fine"))  # phase 13 (d)
SERVE_SEED = 24  # phase 13 (e): rank 0's traffic
WAIT_LIMIT_S = 5.0  # phase 13 (e): the longest a rank may wait in an exchange or agreement
K1_MODELS = ("monoC", "summa2d")  # local compute on K1 alone: bit for bit on the card


def _slim(handle):
    """``handle`` without its hypergraph and partition: what a rank needs to
    compile it, sent to the ranks once."""
    import repro_torch

    return repro_torch.PlannedSpGEMM(instance=handle.instance, model=handle.model,
                                     hypergraph=None, partition=None,
                                     execution_plan=handle.execution_plan)


def rank_csr_operands(handle, a, b, rank: int, device):
    """The A and B nonzeros in ``rank``'s monoC K1 tables (the ones it owns
    and the ones its two expands bring), each a CSR matrix on ``device``
    with its values from the 1-D vectors ``a`` and ``b``, and the multiply
    pairs their CSR @ CSR does: the library's reading of that rank's
    launch, which also forms the pairs of C entries other ranks own."""
    import torch

    plan = handle.execution_plan
    mats, inner = [], []
    for name, s, v in (("a", handle.instance.a, a), ("b", handle.instance.b, b)):
        own = plan.local_ids[f"{name}_nz"][rank]
        recv = plan.routes[f"expand_{name}"].recv_key[:, rank]
        ids = np.unique(np.concatenate([own[own >= 0], recv[recv >= 0]]))
        rows, cols = s.coo()
        idx = torch.as_tensor(np.stack([rows[ids], cols[ids]]), device=device)
        vals = v[torch.as_tensor(ids, device=device)]
        with warnings.catch_warnings():  # CSR is "beta" in PyTorch; not our concern
            warnings.simplefilter("ignore", UserWarning)
            mats.append(torch.sparse_coo_tensor(idx, vals, s.shape).coalesce().to_sparse_csr())
        inner.append(cols[ids] if name == "a" else rows[ids])
    k = handle.instance.a.shape[1]
    pairs = int((np.bincount(inner[0], minlength=k) * np.bincount(inner[1], minlength=k)).sum())
    return mats[0], mats[1], pairs


def block_diag_csr(mats):
    """One CSR matrix holding ``mats`` (CSR, on one device) on its
    diagonal: the library's one call over a batch of products is the
    product of two of them."""
    import torch

    rows, cols, vals, (n_r, n_c) = [], [], [], (0, 0)
    for m in mats:
        coo = m.to_sparse_coo().coalesce()
        idx = coo.indices()
        rows.append(idx[0] + n_r)
        cols.append(idx[1] + n_c)
        vals.append(coo.values())
        n_r, n_c = n_r + m.shape[0], n_c + m.shape[1]
    idx = torch.stack([torch.cat(rows), torch.cat(cols)])
    with warnings.catch_warnings():  # CSR is "beta" in PyTorch; not our concern
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_coo_tensor(idx, torch.cat(vals), (n_r, n_c)).coalesce() \
            .to_sparse_csr()


def _c_values(handle, c):
    """The dense C's values at C's coordinates (CSR order), as numpy, and
    the count of nonzeros outside them."""
    import torch

    crow, ccol = handle.instance.c.coo()
    vals = c[torch.as_tensor(crow, device=c.device), torch.as_tensor(ccol, device=c.device)]
    outside = int(torch.count_nonzero(c)) - int(torch.count_nonzero(vals))
    return vals.cpu().numpy(), outside


def _k1_launches_per_rank(plan) -> np.ndarray:
    """K1 launches a call makes in each rank of a monoC or summa2d plan: one
    per pair list (monoC's one, summa2d's one a stage) with a real pair."""
    stages = [""] if plan.model == "monoC" else [f"_s{t}" for t in range(plan.n_stages)]
    return sum((plan.compute[f"pair_c{s}"] != plan.n_c_slots - 1).any(axis=1).astype(int)
               for s in stages)


def _ep_config():
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(LM_ARCH), n_layers=EP_LAYERS)


def _ep_batch(cfg, device):
    import torch
    from repro_torch.data import SyntheticTokens

    tokens = SyntheticTokens(cfg.vocab, EP_PROMPT, EP_BATCH, seed=0).batch(0)["tokens"]
    return {"tokens": torch.as_tensor(tokens, device=device)}


def _rank_products(group, device, products) -> dict:
    """Phase 13 (a) on one rank: every product compiled over the group, one
    warm-up call, the main run (one call each, the launch counts reset just
    before and read just after), ``RANK_REPS`` timed calls of the counted
    phases (pack and step, a barrier before each; one for
    ``RANK_SLOW_PRODUCTS``), and K1 at this rank's
    monoC 27-PTAP inputs against its plain version and against CSR @ CSR
    of the A and B nonzeros in its tables (``rank_csr_operands``)."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels.bsr_spgemm import bsr_spgemm_local

    dev = lambda x: torch.from_numpy(x).to(device)  # noqa: E731
    exes = []
    for key, handle, a, b in products:
        exe = handle.compile(device=device, group=group)
        a, b = dev(a), dev(b)
        exe(a, b)  # warm-up
        exes.append((key, handle, exe, a, b))
    torch.cuda.synchronize()
    out = {}
    reset_launches()
    for key, handle, exe, a, b in exes:
        exe.runtime.comm.reset()
        c = exe(a, b)
        torch.cuda.synchronize()
        vals, outside = _c_values(handle, c)
        out[key] = {"items": exe.runtime.comm.items_moved, "vals": vals, "outside": outside}
        del c
    k1_launches = dict(bsr_spgemm_local.launches)
    for key, handle, exe, a, b in exes:
        times = []
        for _ in range(1 if key in RANK_SLOW_PRODUCTS else RANK_REPS):
            dist.barrier(group)
            t0 = time.perf_counter()
            exe.runtime(*exe.pack(a, b))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[key]["call_ms"] = times
    key, handle, exe, a, b = next(e for e in exes if "PTAP" in e[0] and e[0].endswith("/monoC"))
    # every rank expands (kernel_inputs is collective); rank 0 alone then
    # times K1 on its inputs while the others wait, so no rank shares the card
    args = exe.runtime.step.kernel_inputs(*exe.runtime.pack(*exe.pack(a, b)))
    k1 = None
    if dist.get_rank(group) == 0:
        a_csr, b_csr, library_pairs = rank_csr_operands(handle, a, b, 0, device)
        k1 = kernel_record(args, library_csr_ms(a_csr, b_csr))
        k1["library_pairs"] = library_pairs
    dist.barrier(group)
    return {"products": out, "k1_launches": k1_launches, "k1": k1}


def _rank_psum(group, device) -> dict:
    """Phase 13 (b) on one rank: ``compressed_psum_mean`` of a seeded bf16
    gradient of ``GRAD_ELEMS`` (a warm-up round, then one timed round),
    held to the rounding of the shared scale against the exact mean."""
    import hashlib

    import torch
    import torch.distributed as dist
    from repro_torch.distributed.comm import all_reduce
    from repro_torch.training.compression import compressed_psum_mean

    rank, n = dist.get_rank(group), dist.get_world_size(group)
    gen = torch.Generator(device=device).manual_seed(1000 + rank)
    x = torch.randn(GRAD_ELEMS, generator=gen, device=device).to(torch.bfloat16)
    err = torch.zeros(GRAD_ELEMS, device=device)
    compressed_psum_mean(x, err, group)
    dist.barrier(group)
    t0 = time.perf_counter()
    mean, new_err = compressed_psum_mean(x, err, group)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    # the checks' own reductions, after the timed round
    exact = all_reduce(x.float(), group) / n
    smax = float(all_reduce(torch.clamp(x.float().abs().max(), min=1e-12) / 127.0, group, "max"))
    return {
        "ms": ms, "elements": GRAD_ELEMS, "scale": smax,
        "max_err_mean": float((mean - exact).abs().max()),
        "max_new_err": float(new_err.abs().max()),
        "finite": bool(mean.isfinite().all()),
        "mean_sha1": hashlib.sha1(mean.cpu().numpy().tobytes()).hexdigest(),
        "wire_bytes": GRAD_ELEMS * 4 + 4,  # one int32 sum and one fp32 max a rank
    }


def _rank_ep(group, device, tokens) -> dict:
    """Phase 13 (c) and (f) on one rank: Qwen3-MoE prefill with its experts
    split over the group (``expert_shard``, ``make_prefill_step(cfg,
    ep_group)``), then ``EP_DECODE_STEPS`` decode steps on its cache.  The
    ranks build the full tree from the seed on the card one at a time and
    keep their shard (a full 2-layer tree is 12 GB).  (c): a warm-up call,
    the main run with the launch counts reset, 3 timed calls, then one call
    with every K3 launch held to its plain version.  (f): ``tokens``, the
    one-process greedy decode's, fed one a step (``_rank_ep_decode``)."""
    import torch
    import torch.distributed as dist
    import repro_torch.kernels.moe_gemm as k3_mod
    from repro_torch.kernels.moe_gemm import moe_gemm
    from repro_torch.models import convert, init_params
    from repro_torch.training import make_prefill_step

    rank, tp = dist.get_rank(group), dist.get_world_size(group)
    cfg = _ep_config()
    torch.cuda.reset_peak_memory_stats()
    for r in range(tp):
        if r == rank:
            full = init_params(cfg, 0, device=device)
            params = convert.expert_shard(full, rank, tp)
            del full
            torch.cuda.empty_cache()
        dist.barrier(group)
    init_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    batch = _ep_batch(cfg, device)
    prefill = make_prefill_step(cfg, ep_group=group)
    prefill(params, batch)
    torch.cuda.synchronize()
    reset_launches()
    logits, cache = prefill(params, batch)
    torch.cuda.synchronize()
    launches = {k: v for k, v in moe_gemm.launches.items() if v}
    calls = timed_ms(lambda: prefill(params, batch), 3)
    records, keep = [], {}
    real = k3_mod.moe_gemm
    try:
        k3_mod.moe_gemm = k3_checked(records, keep, "ep prefill", real)
        prefill(params, batch)
    finally:
        k3_mod.moe_gemm = real
    x, w = keep["ep prefill"]
    k3 = None
    if rank == 0:  # timed alone on the card: the other ranks wait
        k3 = k3_record_at(x, w, launches.get("expert_wgmma", 0),
                          max(r["max_abs_err"] for r in records))
    dist.barrier(group)
    out = {
        "logits": logits.float().cpu().numpy(), "launches": launches, "ms": calls,
        "experts_held": int(params["layers"]["moe"]["wi"].shape[1]),
        "peak_bytes": torch.cuda.max_memory_allocated(), "init_peak_bytes": init_peak,
        "param_bytes": _tree_bytes(params), "k3_checked": len(records), "k3": k3,
    }
    out["decode"] = _rank_ep_decode(group, device, params, cfg, cache, tokens)
    return out


def _rank_ep_decode(group, device, params, cfg, cache, tokens) -> dict:
    """Phase 13 (f) on one rank: ``make_decode_step(cfg, ep_group)`` from
    (c)'s prefill cache, fed the one-process decode's tokens: the main run
    (``EP_DECODE_STEPS`` steps, each timed, the launch counts reset before
    and read after), one step under ``torch.cuda.set_sync_debug_mode("warn")``
    with the warnings and where they rose, and one with every K3 launch
    held to its plain version, both from copies of the cache."""
    import torch
    import torch.distributed as dist
    import repro_torch.kernels.moe_gemm as k3_mod
    from repro_torch.kernels.moe_gemm import moe_gemm
    from repro_torch.training import make_decode_step

    decode = make_decode_step(cfg, ep_group=group)
    start = {k: v.clone() for k, v in cache.items()}
    toks = [torch.as_tensor(t, device=device) for t in tokens]
    decode(params, {k: v.clone() for k, v in start.items()}, toks[0])  # warm-up
    torch.cuda.synchronize()
    dist.barrier(group)
    reset_launches()
    steps, ms = [], []
    for tok in toks:
        t0 = time.perf_counter()
        logits, out = decode(params, cache, tok)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if out is not cache:
            fail("ranks (f): the decode step returned another cache than it was given")
        steps.append(logits.float().cpu().numpy())
    launches = {k: v for k, v in moe_gemm.launches.items() if v}
    pos = int(cache["pos"])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            decode(params, {k: v.clone() for k, v in start.items()}, toks[0])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [(Path(w.filename).name, w.lineno, str(w.message).splitlines()[0][:120])
             for w in caught if "called a synchronizing CUDA operation" in str(w.message)]
    records, keep = [], {}
    real = k3_mod.moe_gemm
    try:
        k3_mod.moe_gemm = k3_checked(records, keep, "ep decode", real)
        decode(params, {k: v.clone() for k, v in start.items()}, toks[0])
    finally:
        k3_mod.moe_gemm = real
    x, w = keep["ep decode"]
    k3 = None
    if dist.get_rank(group) == 0:  # timed alone on the card: the other ranks wait
        k3 = k3_record_at(x, w, launches.get("expert_wgmma", 0),
                          max(r["max_abs_err"] for r in records))
    dist.barrier(group)
    return {"logits": np.stack(steps), "ms": ms, "launches": launches, "pos": pos,
            "syncs": syncs, "k3_checked": len(records), "k3_shape": [list(x.shape),
                                                                     list(w.shape)],
            "k3": k3}


def _rank_batched(group, device, cases) -> dict:
    """Phase 13 (d) on one rank: each case through ``compile(batch=
    BATCH_SETS, group=...)``: a warm-up, then one dispatch of
    ``BATCH_SETS`` value sets and one ragged dispatch of ``RAGGED_SETS``
    (the launch counts and items reset before each and read after), the C
    values of every set, then ``RANK_REPS`` timed rounds of one dispatch and
    of ``BATCH_SETS`` looped unbatched calls over the group (a barrier
    before each); and K1 at rank 0's batched monoC inputs."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels.bsr_spgemm import bsr_spgemm_local

    dev = lambda x: torch.from_numpy(x).to(device)  # noqa: E731
    out, k1 = {}, None
    for key, handle, a, b, a5, b5 in cases:
        exe = handle.compile(device=device, batch=BATCH_SETS, group=group)
        one = handle.compile(device=device, group=group)
        a, b, a5, b5 = dev(a), dev(b), dev(a5), dev(b5)
        exe(a, b), one(a[0], b[0])  # warm-up
        torch.cuda.synchronize()
        rec = {}
        for name, x, y in (("full", a, b), ("ragged", a5, b5)):
            reset_launches()
            exe.runtime.comm.reset()
            c = exe(x, y)
            torch.cuda.synchronize()
            got = [_c_values(handle, c[i]) for i in range(c.shape[0])]
            rec[name] = {"sets": int(c.shape[0]), "items": exe.runtime.comm.items_moved,
                         "k1_launches": dict(bsr_spgemm_local.launches),
                         "vals": np.stack([v for v, _ in got]),
                         "outside": sum(n for _, n in got)}
            del c, got
        batched_ms, looped_ms = [], []
        for _ in range(RANK_REPS):
            dist.barrier(group)
            t0 = time.perf_counter()
            exe(a, b)
            torch.cuda.synchronize()
            batched_ms.append((time.perf_counter() - t0) * 1e3)
            dist.barrier(group)
            t0 = time.perf_counter()
            for i in range(BATCH_SETS):
                one(a[i], b[i])
            torch.cuda.synchronize()
            looped_ms.append((time.perf_counter() - t0) * 1e3)
        rec["batched_ms"], rec["looped_ms"] = batched_ms, looped_ms
        out[key] = rec
        if handle.model == "monoC":
            # every rank expands; rank 0 alone then times K1 on its inputs
            args = exe.runtime.step.kernel_inputs(*exe.runtime.pack(*exe.pack(a, b)))
            if dist.get_rank(group) == 0:  # the library's call: CSR @ CSR, block-diagonal
                sets = [rank_csr_operands(handle, a[i], b[i], 0, device)
                        for i in range(BATCH_SETS)]
                k1 = kernel_record(args, library_csr_ms(block_diag_csr([m[0] for m in sets]),
                                                        block_diag_csr([m[1] for m in sets])))
                k1["library_pairs"] = sum(m[2] for m in sets)
            del args
            dist.barrier(group)
        del exe, one
        torch.cuda.empty_cache()
    return {"cases": out, "k1": k1}


def serving_traffic(seed: int):
    """Phase 10's traffic from ``seed``: (instances by the id of their A
    structure, the 48 requests in order, each (instance, (a, b))), over
    LP-pds100, pds80 and a pds100 with 2% of A's nonzeros moved within
    their rows, times its transpose."""
    from repro_torch.core.matrices import lp_instance
    from repro_torch.core.spgemm_models import SpGEMMInstance

    rng = np.random.default_rng(seed)
    pds100, pds80 = lp_instance("pds100"), lp_instance("pds80")
    drift_a = drifted(pds100.a, 0.02, rng)
    drift = SpGEMMInstance(drift_a, drift_a.transpose(), name="LP-pds100-drift2%")
    cycle = (pds100, pds80, pds100, pds100, pds80, drift)  # 24 : 16 : 8 over 48
    traffic = [(inst, (rng.standard_normal(inst.a.nnz).astype(np.float32),
                       rng.standard_normal(inst.b.nnz).astype(np.float32)))
               for inst in cycle * 8]
    return {id(i.a): i for i in (pds100, pds80, drift)}, traffic, rng


class _Waits:
    """Seconds each ``torch.distributed`` collective the serving tier makes
    took in this process, by name, while installed (``with``)."""

    NAMES = ("all_to_all_single", "all_reduce", "all_gather_object", "broadcast_object_list")

    def __init__(self):
        self.seconds = {name: [] for name in self.NAMES}

    def __enter__(self):
        import torch.distributed as dist

        self._real = {name: getattr(dist, name) for name in self.NAMES}
        for name, fn in self._real.items():
            setattr(dist, name, self._timed(name, fn))
        return self

    def _timed(self, name, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.seconds[name].append(time.perf_counter() - t0)
        return timed

    def __exit__(self, *exc):
        import torch.distributed as dist

        for name, fn in self._real.items():
            setattr(dist, name, fn)

    def summary(self) -> dict:
        return {name: {"calls": len(s), "max_s": max(s, default=0.0), "sum_s": sum(s)}
                for name, s in self.seconds.items()}


def _rank_serving(group, device, store: str) -> dict:
    """Phase 13 (e) on one rank: phase 10's serving over the group.  Rank 0
    holds the traffic (``serving_traffic``), submits it, steps, checks every
    result against scipy and releases it; the others ``follow()``.  (b) 48
    requests in windows of 16 on a plan store; (c) a second server on the
    same store replays 8; (d) a third takes 4 pds100 requests with one
    transient ``"execute"`` fault armed on rank 1 alone.  Every collective
    the ranks make is timed (``_Waits``)."""
    import contextlib

    import torch
    import torch.distributed as dist
    from repro_torch.kernels.bsr_spgemm import bsr_spgemm_local
    from repro_torch.launch.serve import SpGEMMServer
    from repro_torch.testing import faults

    rank = dist.get_rank(group)
    config = dict(p=RANKS, model="monoC", max_batch=8, batch_window=16, pool_entries=4,
                  store_dir=store, device=str(device), group=group)
    inst_of, traffic, rng = serving_traffic(SERVE_SEED) if rank == 0 else (None, None, None)

    def check_and_release(requests):
        errs = []
        for req in requests:
            if req.error is not None or req.result is None:
                fail(f"ranks (e): request {req.rid} failed: {req.error!r}")
            inst = inst_of[id(req.a_s)]
            errs.append(check_product(inst, req.result, req.a_vals, req.b_vals, device,
                                      f"ranks (e) request {req.rid} ({inst.name})"))
            req.result = None
        return errs

    def serve(server, work, step=False):
        """Rank 0: submit ``work``, serve it (one ``step`` a window of 16
        with ``step``, else ``drain``), close; the rest follow."""
        if rank:
            server.follow()
            return {}
        errs, step_s = [], 0.0
        for w in range(0, len(work), 16):
            reqs = [server.submit((inst.a, va), (inst.b, vb)) for inst, (va, vb) in
                    work[w:w + 16]]
            t0 = time.perf_counter()
            server.step() if step else server.drain()
            step_s += time.perf_counter() - t0
            errs += check_and_release(reqs)
        server.close()
        return {"report": server.report(), "steps_s": step_s, "max_abs_err": max(errs)}

    out = {}
    with _Waits() as waits:
        server = SpGEMMServer(**config)
        reset_launches()
        loop = serve(server, traffic, step=True)
        out["loop"] = dict(loop, events=server.session.stats()["events"],
                           dispatches=server.stats.dispatches,
                           k1_launches=bsr_spgemm_local.launches["scalar_runs"])
        server = SpGEMMServer(**config)
        faults.reset_counts()
        replay = None
        if rank == 0:
            cycle = [inst for inst, _ in traffic[:6]] + [traffic[1][0], traffic[5][0]]
            replay = [(inst, (rng.standard_normal(inst.a.nnz).astype(np.float32),
                              rng.standard_normal(inst.b.nnz).astype(np.float32)))
                      for inst in cycle]
        restart = serve(server, replay)
        out["restart"] = dict(restart, events=server.session.stats()["events"],
                              calls=faults.call_counts())
        server = SpGEMMServer(**config)
        work = None
        if rank == 0:
            pds100 = traffic[0][0]
            work = [(pds100, (rng.standard_normal(pds100.a.nnz).astype(np.float32),
                              rng.standard_normal(pds100.b.nnz).astype(np.float32)))
                    for _ in range(4)]
        armed = faults.inject("execute", times=1) if rank == 1 else contextlib.nullcontext()
        with armed as script:
            fault = serve(server, work)
        out["fault"] = dict(fault, fired=None if script is None else script.fired,
                            retries=[e.detail["stage"] for e in server.session.events
                                     if e.kind == "retry"],
                            events=server.session.stats()["events"],
                            failed=server.stats.failed)
    out["waits"] = waits.summary()
    return out


def _phase13_rank(group, device, payload: str) -> dict:
    """What each of phase 13's processes runs: (a), (b), (c) with (f), (d)
    and (e) in turn."""
    import pickle

    import torch

    with open(payload, "rb") as f:
        work = pickle.load(f)
    out = _rank_products(group, device, work.pop("products"))
    torch.cuda.empty_cache()
    out["psum"] = _rank_psum(group, device)
    torch.cuda.empty_cache()
    out["ep"] = _rank_ep(group, device, work["decode_tokens"])
    torch.cuda.empty_cache()
    out["batched"] = _rank_batched(group, device, work.pop("batched"))
    torch.cuda.empty_cache()
    out["serving"] = _rank_serving(group, device, work["store"])
    return out


def ranks_in_processes(handles, device, rng, served=None):
    """Phase 13: ranks in their own processes — ``RANKS`` processes on the
    one card (``launch.ranks.run_ranks``), one rank each, over a gloo group
    that moves the bytes through the host (NCCL refuses two ranks on one
    card).  The parent plans nothing new but summa2d, sends the planned
    handles once (a pickle under ``build/``), holds the results and stops
    every process.

    (a) the seven models (phases 4 and 9's plans) and summa2d on 27-PTAP and
        LP-pds100 at full size, ``compile(group=...)`` in every rank: each
        rank's items a call and their sum against ``moved_items`` and the
        one-process ``Loopback`` count, C on every rank (the same bits on
        all) against the one-process ``Loopback`` result (bit for bit for
        the K1 models monoC and summa2d; within 1e-4 + 1e-4 |want| for the
        rest: the fine family's ``index_add_`` sums in no fixed order on
        the card, and cuBLAS may pick another algorithm for one rank's
        product) and against scipy in float64, a call's time (pack and step,
        each rank's median; the slowest rank), K1 launched once a monoC
        call and once a summa2d stage in every rank, and K1 at rank 0's
        monoC 27-PTAP inputs against its plain version and against CSR @
        CSR of the A and B nonzeros in its tables;
    (b) ``compressed_psum_mean`` on each rank's seeded bf16 gradient of 64 M
        elements, one timed round: the same mean on every rank, within half
        the shared quantization scale of the exact mean;
    (c) Qwen3-MoE-235B-A22B prefill, 2 x 1024 ``SyntheticTokens``, at its
        published widths, bf16, ``n_layers`` cut to 2, with its 128 experts
        split over the 4 ranks (32 each, ``ep_group``): the last-token
        logits of every rank (the same bits on all) within
        ``TOL["bfloat16"]`` (2e-2 + 2e-2 |want|) of the one-process prefill
        in the parent, 3 K3 launches a layer in every rank, every K3 launch
        of one call against its plain version, each rank's peak memory;
    (d) batched over the group: LP-pds100 monoC and 27-PTAP fine through
        ``compile(batch=8, group=...)``, one dispatch of 8 value sets and a
        ragged one of 5: each set's C against the one-process batched
        result (bit for bit for monoC, K1; within 1e-4 + 1e-4 |want| for
        fine, whose ``index_add_`` sums in no fixed order on the card), the
        ranks' items summing to 8 x ``moved_items``, K1 once a dispatch on
        every rank for monoC; ms a dispatch (the slowest rank's median)
        beside 8 looped unbatched group calls and the one-process batched
        dispatch timed here (and phase 10's);
    (e) phase 10's serving over the group (``SpGEMMServer(group=...)``, a
        plan store in a temporary directory): 48 requests in windows of 16,
        a restart on the same store that must restore 3 entries with no
        ``"partition"`` call on any rank, and one transient ``"execute"``
        fault on rank 1 alone that every rank must retry; every result
        against scipy on rank 0; any other retry, downgrade, fallback, store
        error or failure, K1 launches other than one a dispatch, or an
        exchange or agreement that waited past ``WAIT_LIMIT_S`` fails it;
        QPS and p50/p99 on rank 0 beside phase 10's;
    (f) (c)'s prefill continued by 16 decode steps over the 4 ranks
        (``make_decode_step(cfg, ep_group)``, 32 experts a rank), fed the
        one-process greedy decode's tokens: 3 ``expert_wgmma`` launches a
        MoE layer a step on every rank, each K3 launch of a step within the
        bf16 rule of its plain version, the logits bit for bit the
        one-process decode's at every step (when that decode repeats bit
        for bit; else within ``TOL["bfloat16"]``), and the host syncs of a
        step under the sync debug mode only the combine's staging copies
        in ``comm.py`` (two a MoE layer); ms a step beside the one-process
        step timed here and phase 12's.
    A failing rank fails the phase."""
    import pickle
    import shutil
    import tempfile

    import torch
    import repro_torch
    from repro_torch.distributed import runtime
    from repro_torch.distributed.plan_ir import moved_items
    from repro_torch.launch.ranks import run_ranks
    from repro_torch.models import init_params
    from repro_torch.training import make_decode_step, make_prefill_step

    t0 = time.perf_counter()
    for inst in {inst for inst, _ in handles}:
        handles[(inst, "summa2d")] = repro_torch.plan(inst, p=RANKS, model="summa2d")
    products, refs = [], {}
    for (inst, model), handle in sorted(handles.items(), key=lambda kv: (kv[0][0].name,
                                                                          kv[0][1])):
        key = f"{inst.name}/{model}"
        a = rng.standard_normal(inst.a.nnz).astype(np.float32)
        b = rng.standard_normal(inst.b.nnz).astype(np.float32)
        exe = handle.compile(device=device)
        exe.runtime.comm.reset()
        c = exe(torch.from_numpy(a).to(device), torch.from_numpy(b).to(device))
        torch.cuda.synchronize()
        loop, outside = _c_values(handle, c)
        want = (scipy_csr(inst.a, a) @ scipy_csr(inst.b, b)).tocsr()
        want.sum_duplicates()
        want.sort_indices()
        if outside or not (np.array_equal(want.indptr, inst.c.indptr)
                           and np.array_equal(want.indices, inst.c.indices)):
            fail(f"ranks (a) {key}: the one-process result or scipy's structure is off C's")
        refs[key] = {"loop": loop, "want": want.data, "items": exe.runtime.comm.items_moved,
                     "moved": moved_items(handle.execution_plan)}
        if model in K1_MODELS:
            refs[key]["k1"] = _k1_launches_per_rank(handle.execution_plan)
        products.append((key, _slim(handle), a, b))
        del c, exe
    # (d): the one-process batched dispatches the ranks are held to
    inst_by_name = {inst.name: inst for inst, _ in handles}
    batched, batched_refs = [], {}
    for name, model in BATCHED:
        inst = inst_by_name[name]
        handle = handles[(inst, model)]
        key = f"{name}/{model}"
        sets = {n: tuple(rng.standard_normal((n, s.nnz)).astype(np.float32)
                         for s in (inst.a, inst.b)) for n in (BATCH_SETS, RAGGED_SETS)}
        exe = handle.compile(device=device, batch=BATCH_SETS)
        ref = {"moved": moved_items(handle.execution_plan)}
        for what, n in (("full", BATCH_SETS), ("ragged", RAGGED_SETS)):
            a, b = (torch.from_numpy(x).to(device) for x in sets[n])
            exe.runtime.comm.reset()
            c = exe(a, b)
            torch.cuda.synchronize()
            ref[f"{what}_items"] = exe.runtime.comm.items_moved
            ref[what] = np.stack([_c_values(handle, c[i])[0] for i in range(n)])
            if what == "full":
                ref["max_abs_err"] = check_product(inst, c[0], sets[n][0][0], sets[n][1][0],
                                                   device, f"ranks (d) {key} one process")
                ref["one_process_ms"] = statistics.median(timed_ms(lambda: exe(a, b),
                                                                   RANK_REPS))
            del c
        batched_refs[key] = ref
        batched.append((key, _slim(handle), *sets[BATCH_SETS], *sets[RAGGED_SETS]))
        del exe
    runtime.cache_clear()
    torch.cuda.empty_cache()
    # the one-process prefill the EP ranks are held to, and how far a second
    # call of it moves (the card's atomics sum in no fixed order); then (f):
    # its greedy decode from the prefill's cache, twice, each step timed
    cfg = _ep_config()
    params = init_params(cfg, 0, device=device)
    prefill = make_prefill_step(cfg)
    ep_want, cache = prefill(params, _ep_batch(cfg, device))
    ep_want = ep_want.float()
    repeat_diff = float((prefill(params, _ep_batch(cfg, device))[0].float() - ep_want)
                        .abs().max())
    decode = make_decode_step(cfg)
    decode_runs = []
    for _ in range(2):
        run_cache = {k: v.clone() for k, v in cache.items()}
        tok, steps, ms, tokens = ep_want.argmax(-1)[:, None], [], [], []
        for _ in range(EP_DECODE_STEPS):
            tokens.append(tok.cpu().numpy())
            t_step = time.perf_counter()
            logits, run_cache = decode(params, run_cache, tok)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t_step) * 1e3)
            steps.append(logits.float().cpu().numpy())
            tok = logits.argmax(-1)[:, None]
        decode_runs.append((np.stack(steps), ms, tokens))
    decode_want, decode_ms, decode_tokens = decode_runs[0]
    decode_repeat_bitwise = bool(np.array_equal(decode_runs[1][0], decode_want))
    del params, prefill, decode, cache, run_cache, decode_runs
    runtime.cache_clear()
    torch.cuda.empty_cache()
    workdir = ROOT / "build" / "ranks"
    workdir.mkdir(parents=True, exist_ok=True)
    payload = workdir / "products.pkl"
    store = tempfile.mkdtemp(prefix="plan_store_", dir=workdir)
    with open(payload, "wb") as f:
        pickle.dump({"products": products, "batched": batched, "store": store,
                     "decode_tokens": decode_tokens}, f, protocol=pickle.HIGHEST_PROTOCOL)
    del products, batched
    phase("ranks (set-up)", t0)

    t1 = time.perf_counter()
    try:
        results = run_ranks(_phase13_rank, RANKS, device=device, workdir=workdir,
                            args=(str(payload),), timeout=900)
    except (RuntimeError, TimeoutError) as exc:
        fail(f"ranks: {exc}")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    run_s = time.perf_counter() - t1
    phase("ranks (processes)", t1)

    rec = {"ranks": RANKS, "transport": "gloo through the host, 4 processes on one card",
           "run_s": run_s, "products": {}}
    per_rank = [r.result for r in results]
    expected_k1 = np.zeros(RANKS, dtype=int)
    for key, ref in refs.items():
        model = key.rsplit("/", 1)[1]
        got = [r["products"][key] for r in per_rank]
        items = [g["items"] for g in got]
        if sum(items) != ref["moved"] or ref["items"] != ref["moved"]:
            fail(f"ranks (a) {key}: items a rank {items} sum to {sum(items)}, the plan moves "
                 f"{ref['moved']}, one process counted {ref['items']}")
        if any(g["outside"] for g in got) or any(
                not np.array_equal(g["vals"], got[0]["vals"]) for g in got):
            fail(f"ranks (a) {key}: the ranks' C differ, or hold nonzeros outside C")
        vals = got[0]["vals"]
        diff = float(np.abs(vals - ref["loop"]).max(initial=0.0))
        bitwise = bool(np.array_equal(vals, ref["loop"]))
        if model in K1_MODELS and not bitwise:
            fail(f"ranks (a) {key}: not bit for bit the one-process result (max diff {diff})")
        if not (np.abs(vals - ref["loop"]) <= 1e-4 + 1e-4 * np.abs(ref["loop"])).all():
            fail(f"ranks (a) {key}: max diff {diff} from the one-process result")
        err = np.abs(vals.astype(np.float64) - ref["want"])
        if not (err <= 1e-4 + 1e-4 * np.abs(ref["want"])).all():
            fail(f"ranks (a) {key}: max abs err {err.max()} against scipy")
        medians = [statistics.median(g["call_ms"]) for g in got]
        rec["products"][key] = {
            "items_per_rank": items, "items_sum": sum(items), "moved_items": ref["moved"],
            "bitwise_loopback": bitwise, "max_diff_loopback": diff,
            "max_abs_err": float(err.max(initial=0.0)), "call_ms_per_rank": medians,
            "call_ms": max(medians),
        }
        if model in K1_MODELS:
            expected_k1 += ref["k1"]
        print(f"ranks (a) {key}: items {items} sum {sum(items)} == moved_items "
              f"{ref['moved']}; vs Loopback bitwise={bitwise} max_diff={diff:.3g}; "
              f"vs scipy {err.max(initial=0.0):.3g}; call {max(medians):.3f} ms", flush=True)
    k1_launches = [r["k1_launches"] for r in per_rank]
    if [k["scalar_runs"] for k in k1_launches] != expected_k1.tolist() or any(
            sum(k.values()) != k["scalar_runs"] for k in k1_launches) or not all(expected_k1):
        fail(f"ranks (a): K1 launches {k1_launches} in the ranks, not {expected_k1.tolist()} "
             f"scalar_runs")
    rec["k1"] = dict(per_rank[0]["k1"], launches=sum(k["scalar_runs"] for k in k1_launches))

    psum = [r["psum"] for r in per_rank]
    if len({q["mean_sha1"] for q in psum}) != 1 or not all(q["finite"] for q in psum):
        fail(f"ranks (b): the ranks' means differ or are not finite: {psum}")
    for q in psum:
        if q["max_err_mean"] > q["scale"] / 2 + 1e-5 or q["max_new_err"] > q["scale"] / 2 + 1e-5:
            fail(f"ranks (b): error {q['max_err_mean']} / {q['max_new_err']} past half the "
                 f"scale {q['scale']}")
    rec["psum"] = {"ms_per_rank": [q["ms"] for q in psum], "ms": max(q["ms"] for q in psum),
                   **{k: psum[0][k] for k in ("elements", "scale", "wire_bytes")},
                   "max_err_mean": max(q["max_err_mean"] for q in psum)}
    print("ranks (b) compressed_psum_mean", json.dumps(rec["psum"]), flush=True)

    ep = [r["ep"] for r in per_rank]
    want_logits = ep_want.to(device)
    for rank, e in enumerate(ep):
        if e["launches"] != {"expert_wgmma": 3 * EP_LAYERS} or e["experts_held"] != \
                cfg.moe.n_experts // RANKS or e["k3_checked"] != 3 * EP_LAYERS:
            fail(f"ranks (c) rank {rank}: K3 launches {e['launches']}, "
                 f"{e['experts_held']} experts, {e['k3_checked']} checked")
        if not np.array_equal(e["logits"], ep[0]["logits"]):
            fail("ranks (c): the ranks' logits differ")
    ep_err = max_err_within(torch.from_numpy(ep[0]["logits"]).to(device), want_logits,
                            TOL["bfloat16"], "ranks (c): EP prefill against one process")
    rec["ep"] = {
        "config": LM_ARCH, "n_layers": EP_LAYERS, "batch": EP_BATCH, "prompt": EP_PROMPT,
        "experts_per_rank": ep[0]["experts_held"], "max_abs_err": ep_err,
        "one_process_repeat_max_diff": repeat_diff,
        "ms_per_rank": [statistics.median(e["ms"]) for e in ep],
        "peak_bytes_per_rank": [e["peak_bytes"] for e in ep],
        "init_peak_bytes_per_rank": [e["init_peak_bytes"] for e in ep],
        "param_bytes_per_rank": [e["param_bytes"] for e in ep],
    }
    rec["k3"] = dict(ep[0]["k3"], launches=sum(e["launches"]["expert_wgmma"] for e in ep))
    print("ranks (c) EP prefill", json.dumps(rec["ep"]), flush=True)
    print("ranks K1", json.dumps(rec["k1"]), "K3", json.dumps(rec["k3"]), flush=True)

    rec["batched"] = ranks_batched_checks(per_rank, batched_refs, served)
    rec["k1_batched"] = dict(per_rank[0]["batched"]["k1"], launches=sum(
        r["batched"]["cases"]["LP-pds100/monoC"]["full"]["k1_launches"]["scalar_runs"]
        for r in per_rank))
    rec["serving"] = ranks_serving_checks(per_rank, served)
    rec["decode"], rec["k3_decode"] = ranks_decode_checks(
        per_rank, decode_want, decode_ms, decode_repeat_bitwise, cfg)
    return rec


def ranks_batched_checks(per_rank, refs, served) -> dict:
    """Phase 13 (d)'s checks and record, from the ranks' results."""
    out = {}
    for key, ref in refs.items():
        model = key.rsplit("/", 1)[1]
        got = [r["batched"]["cases"][key] for r in per_rank]
        rec = {"moved_items": ref["moved"], "one_process_dispatch_ms": ref["one_process_ms"],
               "one_process_max_abs_err_set0": ref["max_abs_err"]}
        for what, sets in (("full", BATCH_SETS), ("ragged", RAGGED_SETS)):
            items = [g[what]["items"] for g in got]
            if sum(items) != BATCH_SETS * ref["moved"] or ref[f"{what}_items"] != sum(items):
                fail(f"ranks (d) {key} {what}: items {items} sum to {sum(items)}, not "
                     f"{BATCH_SETS} x {ref['moved']} (one process {ref[f'{what}_items']})")
            vals = [g[what]["vals"] for g in got]
            if any(g[what]["outside"] or g[what]["sets"] != sets for g in got) or any(
                    not np.array_equal(v, vals[0]) for v in vals):
                fail(f"ranks (d) {key} {what}: the ranks' C differ, hold {sets} sets not, or "
                     f"hold nonzeros outside C")
            want = ref[what]
            diff = float(np.abs(vals[0] - want).max(initial=0.0))
            bitwise = bool(np.array_equal(vals[0], want))
            if model == "monoC" and not bitwise:
                fail(f"ranks (d) {key} {what}: not bit for bit the one-process batched result "
                     f"(max diff {diff})")
            if not (np.abs(vals[0] - want) <= 1e-4 + 1e-4 * np.abs(want)).all():
                fail(f"ranks (d) {key} {what}: max diff {diff} from one process")
            k1 = [g[what]["k1_launches"] for g in got]
            expect = 1 if model == "monoC" else 0
            if any(k["scalar_runs"] != expect or sum(k.values()) != expect for k in k1):
                fail(f"ranks (d) {key} {what}: K1 launches {k1}, not {expect} a rank")
            rec[what] = {"sets": sets, "items_per_rank": items, "items_sum": sum(items),
                         "bitwise_one_process": bitwise, "max_diff_one_process": diff,
                         "k1_launches_per_rank": [k["scalar_runs"] for k in k1]}
        batched = [statistics.median(g["batched_ms"]) for g in got]
        looped = [statistics.median(g["looped_ms"]) for g in got]
        rec.update(dispatch_ms_per_rank=batched, dispatch_ms=max(batched),
                   looped_8_calls_ms_per_rank=looped, looped_8_calls_ms=max(looped))
        if served is not None and key == "LP-pds100/monoC":
            b = served["stream"]["batched"]
            rec["phase10_one_process_dispatch_ms"] = b["seconds"] / b["calls"] * 1e3
        out[key] = rec
        print(f"ranks (d) {key}", json.dumps(rec), flush=True)
    return out


def ranks_serving_checks(per_rank, served) -> dict:
    """Phase 13 (e)'s checks and record, from the ranks' results."""
    got = [r["serving"] for r in per_rank]
    loop, restart, fault = got[0]["loop"], got[0]["restart"], got[0]["fault"]
    for rank, g in enumerate(got):
        for part in ("loop", "restart", "fault"):
            if g[part]["events"] != got[0][part]["events"]:
                fail(f"ranks (e) {part}: rank {rank}'s events {g[part]['events']} are not "
                     f"rank 0's {got[0][part]['events']}")
        events = g["loop"]["events"]
        unscripted = {k: events.get(k, 0) for k in
                      ("model_downgrade", "engine_fallback", "retry", "store_error")}
        if any(unscripted.values()) or events.get("cold_replan") != 2 or not events.get(
                "warm_replan"):
            fail(f"ranks (e) loop, rank {rank}: events {events}")
        if g["loop"]["k1_launches"] != g["loop"]["dispatches"] or not g["loop"]["dispatches"]:
            fail(f"ranks (e) loop, rank {rank}: {g['loop']['k1_launches']} K1 launches for "
                 f"{g['loop']['dispatches']} dispatches")
        if g["restart"]["events"] != {"restored": 3} or g["restart"]["calls"].get("partition"):
            fail(f"ranks (e) restart, rank {rank}: {g['restart']['events']}, calls "
                 f"{g['restart']['calls']}")
        f = g["fault"]
        if f["retries"] != ["execute"] or f["failed"] or (rank == 1) != (f["fired"] == 1):
            fail(f"ranks (e) fault, rank {rank}: retries {f['retries']}, fired {f['fired']}, "
                 f"{f['failed']} failed")
        waits = g["waits"]
        slowest = max(waits[k]["max_s"] for k in
                      ("all_to_all_single", "all_reduce", "all_gather_object"))
        if slowest > WAIT_LIMIT_S:
            fail(f"ranks (e), rank {rank}: an exchange or agreement waited {slowest} s: {waits}")
    report = loop["report"]
    if report["completed"] != 48 or report["failed"] or restart["report"]["failed"]:
        fail(f"ranks (e): report {report}, restart {restart['report']}")
    rec = {
        "report": report, "events": loop["events"], "steps_s": loop["steps_s"],
        "qps_in_steps": report["completed"] / loop["steps_s"],
        "max_abs_err_vs_scipy": max(loop["max_abs_err"], restart["max_abs_err"],
                                    fault["max_abs_err"]),
        "restart": {"events": restart["events"], "report": restart["report"],
                    "calls_per_rank": [g["restart"]["calls"] for g in got]},
        "fault": {"events": fault["events"], "fired_per_rank": [g["fault"]["fired"]
                                                               for g in got]},
        "waits_per_rank": [g["waits"] for g in got],
        "k1_launches_per_rank": [g["loop"]["k1_launches"] for g in got],
    }
    if served is not None:
        one = served["loop"]
        rec["phase10"] = {"qps": one["report"]["qps"], "qps_in_steps": one["qps_in_steps"],
                          "p50_us": one["report"]["p50_us"], "p99_us": one["report"]["p99_us"]}
    print("ranks (e) serving", json.dumps(rec), flush=True)
    return rec


def ranks_decode_checks(per_rank, want, one_ms, repeat_bitwise: bool, cfg):
    """Phase 13 (f)'s checks and record (and K3's at the decode shape),
    from the ranks' results."""
    dec = [r["ep"]["decode"] for r in per_rank]
    n_moe = cfg.n_layers  # every layer of Qwen3-MoE is a MoE layer
    for rank, d in enumerate(dec):
        if d["launches"] != {"expert_wgmma": 3 * n_moe * EP_DECODE_STEPS} or \
                d["k3_checked"] != 3 * n_moe or d["pos"] != EP_PROMPT + EP_DECODE_STEPS:
            fail(f"ranks (f) rank {rank}: K3 launches {d['launches']}, {d['k3_checked']} "
                 f"checked, pos {d['pos']}")
        places = {(f, line) for f, line, _ in d["syncs"]}
        if len(d["syncs"]) != 2 * n_moe or any(f != "comm.py" for f, _ in places):
            fail(f"ranks (f) rank {rank}: a step's host syncs {d['syncs']}, not the "
                 f"{2 * n_moe} staging copies in comm.py")
        if not np.array_equal(d["logits"], dec[0]["logits"]):
            fail("ranks (f): the ranks' logits differ")
    got = dec[0]["logits"]
    diff = float(np.abs(got - want).max())
    bitwise = bool(np.array_equal(got, want))
    if repeat_bitwise and not bitwise:
        fail(f"ranks (f): the EP decode is not bit for bit the one-process decode (max diff "
             f"{diff}), which repeats bit for bit")
    if not (np.abs(got - want) <= TOL["bfloat16"] * (1 + np.abs(want))).all():
        fail(f"ranks (f): max diff {diff} from the one-process decode")
    rank_ms = [statistics.median(d["ms"]) for d in dec]
    rec = {
        "steps": EP_DECODE_STEPS, "batch": EP_BATCH, "n_layers": cfg.n_layers,
        "experts_per_rank": cfg.moe.n_experts // RANKS,
        "bitwise_one_process": bitwise, "max_diff_one_process": diff,
        "one_process_repeat_bitwise": repeat_bitwise,
        "ms_per_step_per_rank": rank_ms, "ms_per_step": max(rank_ms),
        "one_process_ms_per_step": statistics.median(one_ms),
        "k3_launches_per_step": 3 * n_moe, "syncs_per_step": dec[0]["syncs"],
        "k3_shape": dec[0]["k3_shape"],
    }
    print("ranks (f) EP decode", json.dumps(rec), flush=True)
    k3 = dict(dec[0]["k3"], launches=sum(d["launches"]["expert_wgmma"] for d in dec))
    return rec, k3


TRAIN_LAYERS = 2  # phase 14 (a): of the published 94, as phase 13 (c)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 6  # T = 4096: C = 320 rows an expert
TRAIN_PEAK_BYTES = 75e9
RESUME_TOL = 1e-5  # phase 14 (c), absolute, on every parameter after 8 steps


def k3_train_checked(records: list, keep: dict, keep_when):
    """Stand-ins for ``kernels.moe_gemm``'s ``moe_gemm``,
    ``moe_gemm_backward`` (what ``GroupedGemm`` calls) and ``split3_bf16_t``
    (what ``moe_gemm_backward`` calls on the split route) that hold every
    launch on the card against its plain version on the same inputs: the
    forward products by ``max_err_within`` at the type's tolerance, dx and
    dw by ``grad_err_within``, the transposing split bit for bit.  Each
    records its shapes, launches and error, and the operands of the first
    backward with ``keep_when(x, w)`` are kept under ``keep["backward"]``.
    CPU tensors pass through unchecked."""
    import torch
    import repro_torch.kernels.moe_gemm as k3
    from repro_torch.kernels.ref import moe_gemm_grad_ref, moe_gemm_ref, split3_bf16_t_ref

    real_fwd, real_bwd, real_split_t = k3.moe_gemm, k3.moe_gemm_backward, k3.split3_bf16_t

    def moved(before):
        return {k: v - before[k] for k, v in real_fwd.launches.items() if v != before[k]}

    def fwd(x, w, b_c=128, b_f=128, b_d=512):
        if not x.is_cuda:
            return real_fwd(x, w, b_c, b_f, b_d)
        before = dict(real_fwd.launches)
        out = real_fwd(x, w, b_c, b_f, b_d)
        torch.cuda.synchronize()
        err = max_err_within(out, moe_gemm_ref(x, w), TOL[dtype_name(x.dtype)],
                             f"train: K3 at {tuple(x.shape)} x {tuple(w.shape)}")
        records.append({"call": "forward", "x": list(x.shape), "w": list(w.shape),
                        "launches": moved(before), "max_abs_err": err})
        return out

    def bwd(x, w, dy):
        if not x.is_cuda:
            return real_bwd(x, w, dy)
        before = dict(real_fwd.launches)
        dx, dw = real_bwd(x, w, dy)
        torch.cuda.synchronize()
        want_dx, want_dw = moe_gemm_grad_ref(x, w, dy)
        tol = TOL[dtype_name(x.dtype)]
        errs = [grad_err_within(dx, want_dx, tol, f"train: K3 dx at {tuple(dy.shape)}"),
                grad_err_within(dw, want_dw, tol, f"train: K3 dw at {tuple(x.shape)}")]
        records.append({"call": "backward", "x": list(x.shape), "w": list(w.shape),
                        "launches": moved(before), "max_abs_err_dx": errs[0],
                        "max_abs_err_dw": errs[1],
                        "max_abs_dx": float(want_dx.float().abs().max()),
                        "max_abs_dw": float(want_dw.float().abs().max())})
        if keep_when(x, w):
            keep.setdefault("backward", (x, w, dy.contiguous()))
        return dx, dw

    def split_t(x, pitch):
        out = real_split_t(x, pitch)
        if x.is_cuda:
            torch.cuda.synchronize()
            if not torch.equal(out.view(torch.int16), split3_bf16_t_ref(x, pitch).view(
                    torch.int16)):
                fail(f"train: split3_bf16_t at {tuple(x.shape)} differs from its plain version")
            records.append({"call": "split3_bf16_t", "x": list(x.shape), "pitch": pitch})
        return out

    return fwd, bwd, split_t


def k3_installed(stand_ins):
    """A context that installs ``(moe_gemm, moe_gemm_backward,
    split3_bf16_t)`` stand-ins in ``kernels.moe_gemm`` and puts the real
    ones back."""
    import contextlib

    import repro_torch.kernels.moe_gemm as k3

    @contextlib.contextmanager
    def installed():
        real = k3.moe_gemm, k3.moe_gemm_backward, k3.split3_bf16_t
        k3.moe_gemm, k3.moe_gemm_backward, k3.split3_bf16_t = stand_ins
        try:
            yield
        finally:
            k3.moe_gemm, k3.moe_gemm_backward, k3.split3_bf16_t = real

    return installed()


def k3_grad_records(x, w, dy, launches: dict, errs: dict) -> dict:
    """K3's gradient products at operands the training path gave them:
    ``expert_wgmma_dx`` (dy @ wᵀ) and ``expert_wgmma_dw`` (xᵀ @ dy), each
    held to its plain version by ``grad_err_within`` (whose rule must refuse
    wrong results, ``rule_rejects``), then timed alone by events beside
    its plain version and ``torch.bmm`` on the same operands; the bound is
    each operand read once and the output written once, against bf16
    operations at the tensor cores' peak."""
    import torch
    import repro_torch.kernels.moe_gemm as k3
    from repro_torch.kernels.ref import moe_gemm_ref

    E, C, d = x.shape
    f = w.shape[2]
    n_ops = 2.0 * E * C * d * f
    size = x.element_size()
    cases = {
        "dx": (lambda: k3._grad("expert_wgmma_dx", w, dy, C, d, f),
               lambda: moe_gemm_ref(dy, w.transpose(1, 2)),
               lambda: torch.bmm(dy, w.transpose(1, 2)), E * C * d),
        "dw": (lambda: k3._grad("expert_wgmma_dw", x, dy, C, d, f),
               lambda: moe_gemm_ref(x.transpose(1, 2), dy),
               lambda: torch.bmm(x.transpose(1, 2), dy), E * d * f),
    }
    out = {}
    tol = TOL[dtype_name(x.dtype)]
    for name, (kernel, plain, library, out_elems) in cases.items():
        n_bytes = (x.numel() if name == "dw" else w.numel()) * size + dy.numel() * size + (
            out_elems * size)
        bound_ms, bound_by = bound(n_bytes, n_ops, dtype_name(x.dtype))
        want = plain()
        rule_rejects(want, tol, f"train K3 {name}", grad_scale(want), ("the next expert's", 0))
        err = grad_err_within(kernel(), want, tol, f"train K3 {name}")
        del want
        out[name] = {
            "kernel": f"expert_wgmma_{name}", "shape": [list(x.shape), list(w.shape)],
            "launches": launches[f"expert_wgmma_{name}"],
            "max_abs_err": max(err, errs[name]),
            "ms": cuda_ms(kernel, reps=20), "plain_ms": cuda_ms(plain, reps=3, warmup=1),
            "bound_ms": bound_ms, "bound_by": bound_by, "bound_bytes": n_bytes,
            "bound_flops": n_ops, "library_ms": cuda_ms(library, reps=20),
            "library_call": "torch.bmm",
        }
    return out


def k3_split_grad_records(x, w, dy, launches: dict) -> dict:
    """The fp32 gradient's split-route kernels at operands (b)'s path gave
    them: ``split3_bf16_t`` (w transposed into pieces, as for dx) and the
    two ``expert_split`` launches of ``moe_gemm_backward`` (dx = dy @ wᵀ on
    dy's and wᵀ's pieces, dw = xᵀ @ dy on xᵀ's and dy's), launched as it
    launches them.  Each is checked against its plain version (the split
    bit for bit, the products by ``grad_err_within``) and timed by graph
    replay (they take microseconds at these shapes) beside it and, for the
    products, ``torch.bmm`` in fp32 (TF32 off).  The bounds: the split reads
    w once and writes three bf16 pieces; a product reads its pieces once
    and writes fp32, against fp32-accurate operations on the tensor cores.
    ``launches``: (b)'s ``split3_bf16_t`` launches, and its backward calls
    on the card (each launches one dx and one dw ``expert_split``)."""
    import torch
    import repro_torch.kernels.moe_gemm as k3
    from repro_torch.kernels._build import DTYPE_CODE
    from repro_torch.kernels.ref import moe_gemm_ref, split3_bf16_t_ref

    E, C, d = x.shape
    f = w.shape[2]
    pd, pf, pc = k3._pitch(d), k3._pitch(f), k3._pitch(C)
    tol = TOL["float32"]
    out = {}
    got = k3.split3_bf16_t(w, pd)
    if not torch.equal(got.view(torch.int16), split3_bf16_t_ref(w, pd).view(torch.int16)):
        fail("train (b): split3_bf16_t differs from its plain version")
    n_bytes = w.numel() * 4 + got.numel() * 2  # w read once, three bf16 pieces written
    bound_ms, bound_by = bound(n_bytes, 0.0, "float32")
    out["split3_bf16_t"] = {
        "kernel": "split3_bf16_t", "shape": list(w.shape), "pitch": pd,
        "launches": launches["split3_bf16_t"], "max_abs_err": 0.0,
        "ms": graph_ms(lambda: k3.split3_bf16_t(w, pd)),
        "plain_ms": cuda_ms(lambda: split3_bf16_t_ref(w, pd), reps=5, warmup=1),
        "bound_ms": bound_ms, "bound_by": bound_by, "bound_bytes": n_bytes,
        "library_ms": None}
    dy_p = k3.split3_bf16(dy, pf)
    wt_p, xt_p = got, k3.split3_bf16_t(x, pc)
    dx = torch.empty((E, C, d), dtype=torch.float32, device=x.device)
    dw = torch.empty((E, d, f), dtype=torch.float32, device=x.device)
    code = DTYPE_CODE[torch.float32]
    cases = {
        "dx": (lambda: k3._launch("expert_split", x.device, dy_p.data_ptr(), wt_p.data_ptr(),
                                  dx.data_ptr(), E, C, f, d, pf, pd, code),
               dx, lambda: moe_gemm_ref(dy, w.transpose(1, 2)),
               lambda: torch.bmm(dy, w.transpose(1, 2)), dy_p.numel() + wt_p.numel()),
        "dw": (lambda: k3._launch("expert_split", x.device, xt_p.data_ptr(), dy_p.data_ptr(),
                                  dw.data_ptr(), E, d, C, f, pc, pf, code),
               dw, lambda: moe_gemm_ref(x.transpose(1, 2), dy),
               lambda: torch.bmm(x.transpose(1, 2), dy), xt_p.numel() + dy_p.numel()),
    }
    n_ops = 2.0 * E * C * d * f
    for name, (kernel, result, plain, library, pieces) in cases.items():
        kernel()
        torch.cuda.synchronize()
        want = plain()
        rule_rejects(want, tol, f"train (b) expert_split {name}", grad_scale(want),
                     ("the next expert's", 0))
        err = grad_err_within(result, want, tol, f"train (b) expert_split {name}")
        n_bytes = pieces * 2 + result.numel() * 4
        bound_ms, bound_by = bound(n_bytes, n_ops, "float32_split")
        out[f"expert_split_{name}"] = {
            "kernel": "expert_split", "product": name, "shape": [list(x.shape), list(w.shape)],
            "launches": launches["backward_calls"], "max_abs_err": err,
            "ms": graph_ms(kernel), "plain_ms": cuda_ms(plain, reps=5, warmup=1),
            "bound_ms": bound_ms, "bound_by": bound_by, "bound_bytes": n_bytes,
            "bound_flops": n_ops, "library_ms": graph_ms(library),
            "library_call": "torch.bmm"}
    return out


def timed_trainer(cfg, device, optimizer: str):
    """``launch.train.build_trainer(cfg, device, optimizer=...)`` whose step
    records CUDA events around each optimizer update: returns (step,
    opt_init, events), one (start, end) pair appended a step."""
    import torch
    import repro_torch.launch.train as train_mod
    import repro_torch.training.optimizer as opt_mod

    events = []
    init, update = opt_mod.OPTIMIZERS[optimizer]

    def timed_update(*args, **kw):
        ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev[0].record()
        out = update(*args, **kw)
        ev[1].record()
        events.append(ev)
        return out

    opt_mod.OPTIMIZERS[optimizer] = (init, timed_update)
    try:
        step, opt_init = train_mod.build_trainer(cfg, device, optimizer=optimizer)
    finally:
        opt_mod.OPTIMIZERS[optimizer] = (init, update)
    return step, opt_init, events


def _clone_tree(tree):
    return {k: _clone_tree(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def _grad_leaves(params, cfg, batch):
    """(loss, {path: gradient}) of ``train_loss`` at ``params``."""
    import torch
    from repro_torch.models import train_loss
    from repro_torch.training.optimizer import tree_leaves, tree_map

    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, _ = train_loss(leaves, cfg, batch)
    flat = tree_leaves(leaves)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    return loss, [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]


def training(device):
    """Phase 14: the training path (``launch.train.build_trainer``,
    ``launch.elastic.run_loop``, ``training.make_train_step``,
    ``models.train_loss`` with ``remat_policy="nothing"``, K3 forward and
    backward on every MoE layer).

    (a) Qwen3-MoE-235B-A22B at its published width (phase 12's), bf16,
        ``n_layers`` cut from 94 to ``TRAIN_LAYERS``, random weights from
        seed 0, Adafactor, ``SyntheticTokens`` 4 x 1024 (T = 4096, C = 320
        rows an expert): ``TRAIN_STEPS`` steps through ``run_loop``, the
        first a warm-up; each step's K3 launches exactly 12 a MoE layer (3
        forward, 3 recomputed, 3 ``expert_wgmma_dx`` and 3
        ``expert_wgmma_dw``) and what ``launch_plan`` lists beside them;
        step ms (median), tokens/s, the optimizer's ms alone (events around
        its update in each step), peak memory (under 75 GB), loss and
        gradient norm (finite, norm > 0), a profile of one step; then one
        more step with every K3 launch held to its plain version (the
        forward products by the bf16 rule, dx and dw by that rule scaled to
        the gradient's size, ``grad_err_within``), and the gradient products
        timed beside their plain version and ``torch.bmm``.
    (b) the ten smoke configs (attention, Mamba, hybrid) in fp32: ``train_loss``,
        every gradient leaf (by ``grad_err_within``), and one
        ``make_train_step`` step with AdamW and one with Adafactor, card
        against CPU, within 1e-4, with every
        K3 launch on the card (the split route: ``split3_bf16``,
        ``split3_bf16_t``, ``expert_split``) held to its plain version; the
        gradient's ``split3_bf16_t`` and two ``expert_split`` launches then
        timed at the operands of (b)'s first backward.
    (c) ``launch.train.main`` on the card, 8 steps with ``--ckpt-dir``, at
        the internlm2 smoke config: uninterrupted; with an
        ``InjectedFailure`` at step 5 (``run_loop`` restarts from step 4's
        checkpoint); and stopped after 5 steps then run again to 8 from
        the checkpoint; and at the Qwen3-MoE smoke config uninterrupted and
        stopped and resumed so; each against its uninterrupted run within
        ``RESUME_TOL``."""
    import contextlib
    import dataclasses
    import functools
    import io
    import tempfile

    import torch
    import repro_torch.kernels.moe_gemm as k3
    import repro_torch.launch.train as train_mod
    import repro_torch.training.optimizer as opt_mod
    from repro_torch.configs import all_arch_ids, get_config, get_smoke_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch.elastic import InjectedFailure, run_loop
    from repro_torch.models import init_params
    from repro_torch.training import make_train_step

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = get_config(LM_ARCH)
    cfg = dataclasses.replace(base, n_layers=TRAIN_LAYERS)
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    T = TRAIN_BATCH * TRAIN_SEQ
    cap = int(np.ceil(T * K / E * cfg.moe.capacity_factor))
    rec = {"config": LM_ARCH, "n_layers": TRAIN_LAYERS, "n_layers_published": base.n_layers,
           "dtype": cfg.dtype, "remat_policy": cfg.remat_policy, "optimizer": "adafactor",
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "tokens_per_step": T, "capacity": cap}
    if cfg.remat_policy != "nothing" or cap != 320:
        fail(f"train (a): remat {cfg.remat_policy!r}, capacity {cap}")

    # (a) the optimizer's own time: events around each update of the step
    step, opt_init, opt_events = timed_trainer(cfg, device, "adafactor")
    t_init = time.perf_counter()
    params = init_params(cfg, 0, device=device)
    opt_state = opt_init(params)
    torch.cuda.synchronize()
    rec["init_s"] = time.perf_counter() - t_init
    rec["param_bytes"] = _tree_bytes(params)
    data = SyntheticTokens(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    batches = [{k: torch.as_tensor(v, device=device) for k, v in data.batch(i).items()}
               for i in range(TRAIN_STEPS + 1)]
    steps, metrics, launches = [], [], []

    def step_fn(state, idx):
        reset_launches()
        torch.cuda.synchronize()
        t_step = time.perf_counter()
        p, o, m = step(*state, batches[idx])
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t_step) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
        launches.append({k: v for k, v in k3.moe_gemm.launches.items() if v})
        return p, o

    (params, opt_state), stats = run_loop((params, opt_state), step_fn, TRAIN_STEPS)
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    # what launch_plan lists for the three products of a layer, twice forward
    # (the recompute) and once backward, at this path's shapes
    d, f = cfg.d_model, cfg.moe.d_ff_expert
    xs = torch.empty((E, cap, d), dtype=torch.bfloat16, device=device)
    hs = torch.empty((E, cap, f), dtype=torch.bfloat16, device=device)
    lp = params["layers"]["moe"]
    want = {}
    for x, w, dy in ((xs, lp["wi"][0], hs), (xs, lp["wg"][0], hs), (hs, lp["wo"][0], xs)):
        for plan in (k3.launch_plan(x, w), k3.launch_plan(x, w), k3.grad_launch_plan(x, w, dy)):
            for k, v in plan.items():
                want[k] = want.get(k, 0) + v * TRAIN_LAYERS
    del xs, hs
    if want != {"expert_wgmma": 6 * TRAIN_LAYERS, "expert_wgmma_dx": 3 * TRAIN_LAYERS,
                "expert_wgmma_dw": 3 * TRAIN_LAYERS}:
        fail(f"train (a): launch_plan lists {want} a step")
    for i, got in enumerate(launches):
        if got != want:
            fail(f"train (a): step {i} launched {got}, not {want}")
    for m in metrics:
        if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) and m["grad_norm"] > 0):
            fail(f"train (a): loss {m['loss']}, gradient norm {m['grad_norm']}")
    if rec["peak_bytes"] > TRAIN_PEAK_BYTES:
        fail(f"train (a): peak memory {rec['peak_bytes'] / 1e9:.2f} GB over "
             f"{TRAIN_PEAK_BYTES / 1e9:.0f} GB")
    torch.cuda.synchronize()
    opt_ms = [a.elapsed_time(b) for a, b in opt_events]
    timed = steps[1:]  # the first is the warm-up
    rec["steps"] = {
        "ms": steps, "ms_median": statistics.median(timed),
        "tokens_per_s": T / (statistics.median(timed) / 1e3),
        "optimizer_ms": opt_ms, "optimizer_ms_median": statistics.median(opt_ms[1:]),
        "k3_launches_per_step": launches[-1], "k3_per_moe_layer": sum(
            launches[-1].values()) / TRAIN_LAYERS,
        "metrics": metrics, "restarts": stats.restarts, "stragglers": stats.stragglers,
    }
    print("train (a) steps", json.dumps(rec["steps"]), flush=True)
    state = [params, opt_state]

    def one_step():
        state[0], state[1], _ = step(state[0], state[1], batches[TRAIN_STEPS])

    print("train (a) memory", json.dumps({k: rec[k] for k in (
        "param_bytes", "peak_bytes", "init_s")}), flush=True)
    rec["profile"] = profile_fn(one_step, rec["steps"]["ms_median"], calls=1,
                                label="train step")
    phase("training (a) steps", t0)

    # (a) every K3 launch of one step against its plain version
    checks, operands = [], {}
    up_or_gate = lambda x, w: x.shape[2] == w.shape[1] and w.shape[1] > w.shape[2]  # d > f
    with k3_installed(k3_train_checked(checks, operands, up_or_gate)):
        one_step()
    fwd = [c for c in checks if c["call"] == "forward"]
    bwd = [c for c in checks if c["call"] == "backward"]
    if len(fwd) != 6 * TRAIN_LAYERS or len(bwd) != 3 * TRAIN_LAYERS:
        fail(f"train (a): {len(fwd)} forward and {len(bwd)} backward K3 calls in a step")
    rec["k3_checks"] = checks
    errs = {"dx": max(c["max_abs_err_dx"] for c in bwd),
            "dw": max(c["max_abs_err_dw"] for c in bwd)}
    rec["k3"] = k3_grad_records(*operands["backward"], launches[-1], errs)
    x, w, _ = operands["backward"]
    rec["k3"]["forward"] = k3_record_at(x, w, launches[-1]["expert_wgmma"],
                                        max(c["max_abs_err"] for c in fwd))
    for name, r in rec["k3"].items():
        print(f"train (a) K3 {name}", json.dumps(r), flush=True)
    del params, opt_state, state, operands, x, w, batches
    torch.cuda.empty_cache()
    phase("training (a) K3 checks", t0)

    # (b) the ten smoke configs in fp32, card against CPU, with every K3
    # launch on the card held to its plain version
    reset_launches()
    rec["card_vs_cpu"], rec["card_vs_cpu_rel"] = {}, {}
    checks, operands = [], {}
    stand_ins = k3_train_checked(checks, operands, lambda x, w: True)
    for arch in all_arch_ids():
        scfg = get_smoke_config(arch)
        cpu_params = init_params(scfg, 0, device="cpu")
        rng = np.random.default_rng(0)
        n_front = 16 if scfg.frontend == "vision" else 0
        b = {k: rng.integers(0, scfg.vocab, (2, 64 - n_front)).astype(np.int32)
             for k in ("tokens", "labels")}
        if n_front:
            b["frontend_embeds"] = rng.standard_normal((2, n_front, scfg.d_model)).astype(
                np.float32)
        what = f"train (b) {arch}"
        lc, gc = _grad_leaves(cpu_params, scfg, b)
        with k3_installed(stand_ins):
            lg, gg = _grad_leaves(_tree_to(cpu_params, device), scfg, b)
        errs = [max_err_within(lg.cpu(), lc, TOL["float32"], f"{what} loss")]
        errs += [grad_err_within(g.cpu(), c, TOL["float32"], f"{what} gradient")
                 for g, c in zip(gg, gc)]
        # each leaf's largest difference over its largest value (recorded)
        rec["card_vs_cpu_rel"][arch] = max(
            float((g.cpu() - c).abs().max() / c.abs().max().clamp(min=1e-30))
            for g, c in zip(gg, gc) if c.numel())
        for opt in ("adamw", "adafactor"):
            stp = make_train_step(scfg, optimizer=opt)
            init_fn = opt_mod.OPTIMIZERS[opt][0]
            pc, pg = _clone_tree(cpu_params), _tree_to(cpu_params, device)
            pc, _, mc = stp(pc, init_fn(pc), b)
            with k3_installed(stand_ins):
                pg, _, mg = stp(pg, init_fn(pg), b)
            errs += [max_err_within(mg[k].cpu(), mc[k], TOL["float32"], f"{what} {opt} {k}")
                     for k in mc]
            errs += [max_err_within(g.cpu(), c, TOL["float32"], f"{what} {opt} parameters")
                     for g, c in zip(opt_mod.tree_leaves(pg), opt_mod.tree_leaves(pc))]
        rec["card_vs_cpu"][arch] = max(errs)
    bwd = [c for c in checks if c["call"] == "backward"]
    split_t = [c for c in checks if c["call"] == "split3_bf16_t"]
    launched = dict(k3.moe_gemm.launches)
    plan = {"split3_bf16": 1, "split3_bf16_t": 2, "expert_split": 2}
    if not bwd or any(c["launches"] != plan for c in bwd):
        fail(f"train (b): backward launches {[c['launches'] for c in bwd]}, not {plan} each")
    if len(split_t) != launched["split3_bf16_t"] or len(split_t) != 2 * len(bwd):
        fail(f"train (b): {len(split_t)} split3_bf16_t checked of "
             f"{launched['split3_bf16_t']} launched, {len(bwd)} backward calls")
    rec["k3_checks_fp32"] = {"forward": sum(c["call"] == "forward" for c in checks),
                             "backward": len(bwd), "split3_bf16_t": len(split_t),
                             "launches": {k: v for k, v in launched.items() if v}}
    print("train (b) card vs CPU", json.dumps(rec["card_vs_cpu"]),
          json.dumps(rec["card_vs_cpu_rel"]), json.dumps(rec["k3_checks_fp32"]), flush=True)
    rec["k3"].update(k3_split_grad_records(*operands["backward"], {
        "split3_bf16_t": launched["split3_bf16_t"], "backward_calls": len(bwd)}))
    for name in ("split3_bf16_t", "expert_split_dx", "expert_split_dw"):
        print(f"train (b) K3 {name}", json.dumps(rec["k3"][name]), flush=True)
    del operands
    torch.cuda.empty_cache()
    phase("training (b) card vs CPU", t0)

    # (c) launch.train.main end to end: uninterrupted, a failure, a restart
    argv = ["--arch", "internlm2-1.8b", "--smoke", "--steps", "8", "--ckpt-every", "2",
            "--seq-len", "64", "--global-batch", "4", "--device", "cuda"]

    def main_run(ckpt_dir, steps=None, injector=None, arch="internlm2-1.8b"):
        args = list(argv) + ["--ckpt-dir", ckpt_dir]
        args[args.index("--arch") + 1] = arch
        if steps is not None:
            args[args.index("--steps") + 1] = str(steps)
        out = io.StringIO()
        real_loop = train_mod.run_loop
        if injector is not None:
            train_mod.run_loop = functools.partial(run_loop, failure_injector=injector)
        try:
            with contextlib.redirect_stdout(out):
                params = train_mod.main(args)
        finally:
            train_mod.run_loop = real_loop
        done = [l for l in out.getvalue().splitlines() if l.startswith("done:")]
        return params, done[-1]

    crashed = {"done": False}

    def injector(step):
        if step == 5 and not crashed["done"]:
            crashed["done"] = True
            raise InjectedFailure("simulated node loss")

    with tempfile.TemporaryDirectory() as tmp:
        want, done_a = main_run(f"{tmp}/a")
        failed, done_b = main_run(f"{tmp}/b", injector=injector)
        main_run(f"{tmp}/c", steps=5)
        resumed, done_c = main_run(f"{tmp}/c")
        # the MoE backward (K3's gradient, the dispatch gather's) resumed too
        want_moe, done_d = main_run(f"{tmp}/d", arch=LM_ARCH)
        main_run(f"{tmp}/e", steps=5, arch=LM_ARCH)
        resumed_moe, done_e = main_run(f"{tmp}/e", arch=LM_ARCH)
    if ("1 restarts" not in done_b or "0 restarts" not in done_a or "3 steps" not in done_c
            or "3 steps" not in done_e):
        fail(f"train (c): {done_a!r} / {done_b!r} / {done_c!r} / {done_e!r}")
    leaves = lambda t: opt_mod.tree_leaves(t)
    rec["resume"] = {"tol": RESUME_TOL, "runs": [done_a, done_b, done_c, done_d, done_e]}
    for name, got, ref in (("injected_failure", failed, want), ("restart", resumed, want),
                           ("restart_moe", resumed_moe, want_moe)):
        err = max(float((g.float() - w.float()).abs().max()) for g, w in
                  zip(leaves(got), leaves(ref)))
        rec["resume"][name] = err
        if not err <= RESUME_TOL:
            fail(f"train (c): {name} run off the uninterrupted one by {err}")
    print("train (c) resume", json.dumps(rec["resume"]), flush=True)
    phase("training (c) launch.train", t0)
    rec["phase_s"] = time.perf_counter() - t0
    return rec


SSM_ARCHS = ("falcon-mamba-7b", "hymba-1.5b")  # phase 15, at published widths and depth
SSM_SERVE = {"falcon-mamba-7b": (8, 1024), "hymba-1.5b": (2, 4096)}  # (batch, prompt)
SSM_DECODE_STEPS = 16
SSM_TRAIN = {"falcon-mamba-7b": ("adafactor", 4), "hymba-1.5b": ("adamw", 3)}  # optimizer, steps
# falcon-mamba's depth cut from 64 to 16 (widths whole): at 64 layers the
# phase took 250 s (a step 5.2 s; its profile 44 s), past its ~150 s
SSM_TRAIN_LAYERS = {"falcon-mamba-7b": 16, "hymba-1.5b": 32}
SSM_TRAIN_BATCH, SSM_TRAIN_SEQ = 4, 1024
SSM_PEAK_BYTES = 75e9
SCAN_SHAPE = (1, 1024, 8192, 16)  # phase 15 (d): one falcon-mamba layer's scan, B = 1
SSM_PREFILL_DECODE_TOL = 1e-3  # phase 15 (e), fp32, as phase 12 (e)


def _ssm_cache_checked(cfg, cache, B: int, S: int, what: str) -> None:
    """Fails unless ``cache`` (a prefill's) holds the reference's keys and
    shapes for ``cfg.layer_kind``: the SSM's conv tail and fp32 state, and
    (hybrid) a KV ring of C = min(window, S) slots rotated so position p
    sits at slot p % C."""
    import torch
    from repro_torch.models.transformer import kv_cache_len

    L, Di, N, Kc = cfg.n_layers, cfg.d_inner, cfg.ssm.d_state, cfg.ssm.d_conv
    want = {"pos": ((), torch.int32), "conv": ((L, B, Kc - 1, Di), torch.bfloat16),
            "h": ((L, B, Di, N), torch.float32)}
    if cfg.layer_kind == "hybrid":
        C = kv_cache_len(cfg, S)
        kv = ((L, B, C, cfg.n_kv_heads, cfg.head_dim), torch.bfloat16)
        want.update(k=kv, v=kv, cache_pos=((L, C), torch.int32))
    got = {k: (tuple(v.shape), v.dtype) for k, v in cache.items()}
    if got != want:
        fail(f"{what}: cache {got}, not {want}")
    if int(cache["pos"]) != S or not bool(cache["h"].isfinite().all()):
        fail(f"{what}: cache pos {int(cache['pos'])}, state finite "
             f"{bool(cache['h'].isfinite().all())}")
    if cfg.layer_kind == "hybrid":
        held = torch.arange(S - C, S, device=cache["cache_pos"].device, dtype=torch.int32)
        if not bool((cache["cache_pos"][:, held % C] == held).all()):
            fail(f"{what}: the KV ring does not hold position p at slot p % {C}")


def ssm_serving(arch: str, device) -> dict:
    """Phase 15 (a) falcon-mamba-7b, (b) hymba-1.5b: serving at published
    widths and depth, bf16, random weights from seed 0 (``SSM_SERVE``'s
    batch and prompt).  ``make_prefill_step`` on ``SyntheticTokens``: the
    cache's keys, shapes and ring, median ms of 3 calls after a warm-up,
    tokens/s and a profile of one call; then ``SSM_DECODE_STEPS`` greedy
    ``make_decode_step`` steps on the returned cache: ms a step (median),
    tokens/s, one step under ``torch.cuda.set_sync_debug_mode("error")``,
    a profile of 3 steps, and the step's byte bound (every weight read once,
    of the embedding table the B rows gathered; the fp32 state and conv tail
    read and written; hymba's KV ring read).  Peak memory under 75 GB."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.models import init_params, param_count
    from repro_torch.training import make_decode_step, make_prefill_step

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(arch)
    B, S = SSM_SERVE[arch]
    rec = {"config": arch, "layer_kind": cfg.layer_kind, "n_layers": cfg.n_layers,
           "dtype": cfg.dtype, "params": param_count(cfg), "batch": B, "prompt": S}
    t_init = time.perf_counter()
    params = init_params(cfg, 0, device=device)
    torch.cuda.synchronize()
    rec["init_s"] = time.perf_counter() - t_init
    rec["param_bytes"] = _tree_bytes(params)
    tokens = torch.as_tensor(SyntheticTokens(cfg.vocab, S, B, seed=0).batch(0)["tokens"],
                             device=device)
    batch = {"tokens": tokens}
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    logits, cache = prefill(params, batch)  # the warm-up, checked
    torch.cuda.synchronize()
    if logits.shape != (B, cfg.vocab) or not bool(logits.isfinite().all()):
        fail(f"{arch} prefill: logits {tuple(logits.shape)}, finite "
             f"{bool(logits.isfinite().all())}")
    _ssm_cache_checked(cfg, cache, B, S, f"{arch} prefill")
    del logits, cache
    calls = timed_ms(lambda: prefill(params, batch), 3)
    ms = statistics.median(calls)
    rec["prefill"] = {"tokens": B * S, "ms_median": ms, "ms": calls,
                      "tokens_per_s": B * S / (ms / 1e3)}
    rec["prefill"]["profile"] = profile_fn(lambda: prefill(params, batch), ms, calls=1,
                                           label=f"{arch} prefill")
    print(f"SSM {arch} prefill", json.dumps(rec["prefill"]), flush=True)
    phase(f"SSM {arch} prefill", t0)

    logits, cache = prefill(params, batch)
    tok = logits.argmax(-1)[:, None]
    steps = []
    for _ in range(SSM_DECODE_STEPS):
        t_step = time.perf_counter()
        logits, cache = decode(params, cache, tok)
        tok = logits.argmax(-1)[:, None]
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t_step) * 1e3)
    if not bool(logits.isfinite().all()) or int(cache["pos"]) != S + SSM_DECODE_STEPS:
        fail(f"{arch} decode: logits finite {bool(logits.isfinite().all())}, "
             f"pos {int(cache['pos'])}")
    torch.cuda.set_sync_debug_mode("error")  # a step must never wait for the card
    try:
        logits, cache = decode(params, cache, tok)
    except RuntimeError as e:
        fail(f"{arch} decode: a step waits for the card: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    table = params["embed"]["tokens"]
    es = table.element_size()
    state_bytes = 2 * sum(cache[k].numel() * cache[k].element_size() for k in ("h", "conv"))
    kv_bytes = sum(cache[k].numel() * cache[k].element_size() for k in ("k", "v") if k in cache)
    step_bytes = (rec["param_bytes"] - table.numel() * es + B * cfg.d_model * es
                  + state_bytes + kv_bytes)
    step_ms = statistics.median(steps)
    rec["decode"] = {
        "batch": B, "steps": SSM_DECODE_STEPS, "ms_per_step_median": step_ms, "ms": steps,
        "tokens_per_s": B / (step_ms / 1e3), "bound_bytes": step_bytes,
        "state_bytes": state_bytes, "kv_bytes": kv_bytes,
        "bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3,
    }
    rec["decode"]["profile"] = profile_fn(lambda: decode(params, cache, tok), step_ms, calls=3,
                                          label=f"{arch} decode step")
    print(f"SSM {arch} decode", json.dumps(rec["decode"]), flush=True)
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    if rec["peak_bytes"] > SSM_PEAK_BYTES:
        fail(f"{arch} serving: peak memory {rec['peak_bytes'] / 1e9:.2f} GB over "
             f"{SSM_PEAK_BYTES / 1e9:.0f} GB")
    del params, cache, logits, batch, tokens
    torch.cuda.empty_cache()
    phase(f"SSM {arch} decode", t0)
    rec["phase_s"] = time.perf_counter() - t0
    return rec


def ssm_training(arch: str, device) -> dict:
    """Phase 15 (c): ``arch`` trained at its published widths,
    ``SSM_TRAIN_LAYERS`` deep, bf16, random weights from seed 0,
    ``SSM_TRAIN``'s optimizer, ``SyntheticTokens`` 4 x 1,024 a step, through
    ``launch.train.build_trainer`` and ``launch.elastic.run_loop`` with
    ``remat_policy="nothing"``, the first step a warm-up: step ms (median),
    tokens/s, the optimizer's ms (events), peak memory under 75 GB, loss
    finite and gradient norm > 0 every step, a profile of one step."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch.elastic import run_loop
    from repro_torch.models import init_params, param_count

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = get_config(arch)
    cfg = dataclasses.replace(base, n_layers=SSM_TRAIN_LAYERS[arch])
    optimizer, n_steps = SSM_TRAIN[arch]
    T = SSM_TRAIN_BATCH * SSM_TRAIN_SEQ
    rec = {"config": arch, "n_layers": cfg.n_layers, "n_layers_published": base.n_layers,
           "dtype": cfg.dtype, "params": param_count(cfg), "remat_policy": cfg.remat_policy,
           "optimizer": optimizer, "batch": SSM_TRAIN_BATCH, "seq": SSM_TRAIN_SEQ,
           "tokens_per_step": T}
    if cfg.remat_policy != "nothing":
        fail(f"{arch} train: remat {cfg.remat_policy!r}")
    step, opt_init, opt_events = timed_trainer(cfg, device, optimizer)
    t_init = time.perf_counter()
    params = init_params(cfg, 0, device=device)
    opt_state = opt_init(params)
    torch.cuda.synchronize()
    rec["init_s"] = time.perf_counter() - t_init
    rec["param_bytes"] = _tree_bytes(params)
    data = SyntheticTokens(cfg.vocab, SSM_TRAIN_SEQ, SSM_TRAIN_BATCH, seed=0)
    batches = [{k: torch.as_tensor(v, device=device) for k, v in data.batch(i).items()}
               for i in range(n_steps + 1)]
    steps, metrics = [], []

    def step_fn(state, idx):
        torch.cuda.synchronize()
        t_step = time.perf_counter()
        p, o, m = step(*state, batches[idx])
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t_step) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
        return p, o

    (params, opt_state), stats = run_loop((params, opt_state), step_fn, n_steps)
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    for m in metrics:
        if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) and m["grad_norm"] > 0):
            fail(f"{arch} train: loss {m['loss']}, gradient norm {m['grad_norm']}")
    if rec["peak_bytes"] > SSM_PEAK_BYTES:
        fail(f"{arch} train: peak memory {rec['peak_bytes'] / 1e9:.2f} GB over "
             f"{SSM_PEAK_BYTES / 1e9:.0f} GB")
    torch.cuda.synchronize()
    opt_ms = [a.elapsed_time(b) for a, b in opt_events]
    ms = statistics.median(steps[1:])  # the first is the warm-up
    rec["steps"] = {"ms": steps, "ms_median": ms, "tokens_per_s": T / (ms / 1e3),
                    "optimizer_ms": opt_ms, "optimizer_ms_median": statistics.median(opt_ms[1:]),
                    "metrics": metrics, "restarts": stats.restarts,
                    "stragglers": stats.stragglers}
    print(f"SSM {arch} train", json.dumps(rec["steps"]),
          json.dumps({k: rec[k] for k in ("param_bytes", "peak_bytes", "init_s")}), flush=True)
    state = [params, opt_state]

    def one_step():
        state[0], state[1], _ = step(state[0], state[1], batches[n_steps])

    rec["profile"] = profile_fn(one_step, ms, calls=1, label=f"{arch} train step")
    del params, opt_state, state, batches
    torch.cuda.empty_cache()
    phase(f"SSM {arch} train", t0)
    rec["phase_s"] = time.perf_counter() - t0
    return rec


def scan_on_the_card(device) -> dict:
    """Phase 15 (d): ``mamba_scan`` alone at one falcon-mamba layer's shape
    (``SCAN_SHAPE``: B 1, S 1,024, Di 8,192, N 16), decays exp(dt A) of the
    model's range (A = -(1..16), dt up to 1: log a down to -16), bx and h0
    from a seeded normal: h_all and h_last against a float64 sequential
    recurrence on the card by the fp32 rule (1e-4 + 1e-4 |want|); the
    gradients of sum(h_all w) + sum(h_last v) (``LinearScan``'s reverse
    recurrence) against float64 autograd of that loop by
    ``grad_err_within``; each rule must refuse zeros, a 10% error and a
    one-step shift in time.  Then the forward and backward timed (events)
    beside the bytes their form moves and the least bytes the function
    needs (each input read once, each output written once)."""
    import torch
    from repro_torch.models.layers import LinearScan, mamba_scan

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    B, S, Di, N = SCAN_SHAPE
    g = torch.Generator(device=device).manual_seed(0)
    dt = torch.rand((B, S, Di, 1), generator=g, device=device) * 0.99 + 0.01
    a = torch.exp(dt * -torch.arange(1, N + 1, dtype=torch.float32, device=device))
    bx, w = (torch.randn((B, S, Di, N), generator=g, device=device) for _ in range(2))
    h0, v = (torch.randn((B, Di, N), generator=g, device=device) for _ in range(2))
    del dt
    ins = [t.clone().requires_grad_() for t in (a, bx, h0)]
    h_all, h_last = mamba_scan(*ins)
    grads = torch.autograd.grad((h_all * w).sum() + (h_last * v).sum(), ins)

    ins64 = [t.double().requires_grad_() for t in (a, bx, h0)]
    h, hs = ins64[2], []
    for t in range(S):
        h = ins64[0][:, t] * h + ins64[1][:, t]
        hs.append(h)
    want_all = torch.stack(hs, dim=1)
    del hs
    want_grads = torch.autograd.grad((want_all * w.double()).sum() + (h * v.double()).sum(),
                                     ins64)
    want_all, want_last = want_all.detach(), h.detach()
    rec = {"shape": list(SCAN_SHAPE), "tol": TOL["float32"],
           "log_a_min": float(a.log().min()), "h_abs_max": float(want_all.abs().max())}
    tol = TOL["float32"]
    rec["max_abs_err"] = {
        "h_all": max_err_within(h_all.detach(), want_all, tol, "scan (d): h_all"),
        "h_last": max_err_within(h_last.detach(), want_last, tol, "scan (d): h_last"),
    }
    step_back = ("shifted one step in time", 1)
    rule_rejects(want_all, tol, "scan (d): h_all", shift=step_back)
    for name, got, want in zip(("a", "bx", "h0"), grads, want_grads):
        rec["max_abs_err"][f"d{name}"] = grad_err_within(got, want, tol, f"scan (d): d{name}")
        rule_rejects(want, tol, f"scan (d): d{name}", grad_scale(want),
                     shift=None if name == "h0" else step_back)
    del ins64, want_all, want_last, want_grads, h, grads, h_all, h_last
    torch.cuda.empty_cache()

    # the forward alone, and LinearScan's backward alone (on the time-major
    # views mamba_scan hands it; its inputs are leaves)
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: mamba_scan(a, bx, h0), reps=5, warmup=1)
    h_tm = LinearScan.apply(ins[0].transpose(0, 1), ins[1].transpose(0, 1), ins[2])
    w_tm = w.transpose(0, 1).contiguous()
    bwd_ms = cuda_ms(lambda: torch.autograd.grad(h_tm, ins, w_tm, retain_graph=True), reps=5,
                     warmup=1)
    one = a.numel() * a.element_size()  # one (B, S, Di, N) fp32 pass
    small = h0.numel() * h0.element_size()
    rec["forward"] = {
        "ms": fwd_ms, "launches": S,
        # a step reads a_t, bx_t and h_{t-1} and writes h_t
        "form_bytes": 4 * one, "form_ms": 4 * one / HBM_BYTES_PER_S * 1e3,
        # a, bx and h0 read once, h_all written once
        "bound_bytes": 3 * one + small, "bound_ms": (3 * one + small) / HBM_BYTES_PER_S * 1e3,
    }
    rec["backward"] = {
        "ms": bwd_ms, "launches": S + 2,
        # the loop reads dh_t, a_{t+1}, g_{t+1} and writes g_t; da reads g and
        # h_all and writes da
        "form_bytes": 7 * one, "form_ms": 7 * one / HBM_BYTES_PER_S * 1e3,
        # dh, a and h_all read once, da and dbx written once
        "bound_bytes": 5 * one + 2 * small,
        "bound_ms": (5 * one + 2 * small) / HBM_BYTES_PER_S * 1e3,
    }
    for part in ("forward", "backward"):
        if rec[part]["ms"] < rec[part]["bound_ms"]:
            fail(f"scan (d): the {part} took {rec[part]['ms']} ms, under its bound")
    print("SSM scan", json.dumps(rec), flush=True)
    del a, bx, h0, w, v, ins, h_tm, w_tm
    torch.cuda.empty_cache()
    phase("SSM scan (d)", t0)
    return rec


def ssm_prefill_vs_decode(device) -> dict:
    """Phase 15 (e): for each SSM architecture at its published widths in
    fp32, 2 layers, B = 1, S = 64: prefill's last logits against 64
    token-by-token decode steps from an empty cache, within 1e-3, the
    state too."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.models import init_kv_cache, init_params
    from repro_torch.training import make_decode_step, make_prefill_step

    t0 = time.perf_counter()
    out = {}
    for arch in SSM_ARCHS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = dataclasses.replace(get_config(arch), n_layers=2, dtype="float32")
        params = init_params(cfg, 1, device=device)
        toks = torch.as_tensor(SyntheticTokens(cfg.vocab, 64, 1, seed=1).batch(0)["tokens"],
                               device=device)
        want, want_cache = make_prefill_step(cfg)(params, {"tokens": toks})
        cache = init_kv_cache(cfg, 1, 64, device=device)
        decode = make_decode_step(cfg)
        for i in range(64):
            got, cache = decode(params, cache, toks[:, i:i + 1])
        what = f"SSM (e) {arch}: prefill against decode"
        tol = SSM_PREFILL_DECODE_TOL
        out[arch] = {
            "n_layers": 2, "dtype": "float32", "batch": 1, "seq": 64, "tol": tol,
            "max_abs_err": max_err_within(got, want, tol, what),
            "max_abs_err_h": max_err_within(cache["h"], want_cache["h"], tol, f"{what}, state"),
            "peak_bytes": torch.cuda.max_memory_allocated(),
        }
        del params, cache, want_cache
    torch.cuda.empty_cache()
    print("SSM (e) prefill vs decode", json.dumps(out), flush=True)
    phase("SSM (e) prefill vs decode", t0)
    return out


def ssm(device) -> dict:
    """Phase 15: the Mamba and hybrid layers on the card, falcon-mamba-7b
    and hymba-1.5b at their published widths: (a), (b) serving
    (``ssm_serving``), (c) training (``ssm_training``), (d) the scan alone
    (``scan_on_the_card``), (e) prefill against decode
    (``ssm_prefill_vs_decode``)."""
    t0 = time.perf_counter()
    rec = {"serve": {arch: ssm_serving(arch, device) for arch in SSM_ARCHS}}
    rec["train"] = {arch: ssm_training(arch, device) for arch in SSM_ARCHS}
    rec["scan"] = scan_on_the_card(device)
    rec["prefill_vs_decode"] = ssm_prefill_vs_decode(device)
    rec["phase_s"] = time.perf_counter() - t0
    return rec


MESH_DRYRUN = (  # phase 16 (a): (arch, shape, multi-pod, layers or None for all), at full width
    ("internlm2-1.8b", "decode_32k", False, None),
    ("internlm2-1.8b", "decode_32k", True, None),
    ("qwen3-moe-235b-a22b", "train_4k", False, None),
    ("internlm2-1.8b", "train_4k", True, 2),  # the multi-pod train cell, cut to 2 of 24 layers
)
MESH_DRYRUN_LIMIT_S = 400  # from their start, as phase 15 starts
MESH_DECODE_STEPS = 4  # phase 16 (b), after a prefill of EP_BATCH x EP_PROMPT at EP_LAYERS


def start_dry_runs() -> list:
    """Phase 16 (a), started as phase 15 starts: each dry-run cell in a
    process of its own (``python -m repro_torch.launch.dryrun``: a fake
    group of 256 or 512 ranks, fake tensors on a CPU mesh, nothing on the
    card, one thread), on three of the host's cores while the card runs
    phase 15, whose host-paced times (its decode steps, the scan) they
    may slow; phases 1-14, whose times the kernels line reads, run without
    them.  Every process is killed at exit if it is still running."""
    out = OUT / "dryrun"
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    runs = []
    for arch, shape, multi_pod, layers in MESH_DRYRUN:
        mesh = "2x16x16" if multi_pod else "16x16"
        name = f"{arch}_{shape}_{mesh}" + (f"_L{layers}" if layers else "")
        log = open(out / f"{name}.log", "w")
        args = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                "--shape", shape, "--out", str(out)] + (["--multi-pod"] if multi_pod else []) + (
                    ["--layers", str(layers)] if layers else [])
        proc = subprocess.Popen(args, stdout=log, stderr=subprocess.STDOUT, env=env, cwd=ROOT)
        runs.append({"name": name, "proc": proc, "log": log, "t0": time.perf_counter()})

    def stop():
        for run in runs:
            if run["proc"].poll() is None:
                run["proc"].kill()
                run["proc"].wait()
            run["log"].close()

    atexit.register(stop)
    return runs


def dry_runs(runs, device) -> dict:
    """Phase 16 (a): each dry run's record (status ok, or the phase fails),
    its per-device argument, output and temp bytes beside the card's own
    memory, its trace seconds, FLOPs and collectives."""
    import torch

    total = torch.cuda.get_device_properties(device).total_memory
    recs = {"card_total_memory": total}
    for run in runs:
        name = run["name"]
        left = MESH_DRYRUN_LIMIT_S - (time.perf_counter() - run["t0"])
        try:
            code = run["proc"].wait(timeout=max(left, 1.0))
        except subprocess.TimeoutExpired:
            fail(f"mesh (a): the dry run {name} still runs after {MESH_DRYRUN_LIMIT_S} s")
        run["log"].flush()
        path = OUT / "dryrun" / f"{name}.json"
        rec = json.loads(path.read_text()) if path.exists() else {"status": "no record"}
        if code != 0 or rec["status"] != "ok":
            tail = (OUT / "dryrun" / f"{name}.log").read_text().splitlines()[-20:]
            fail(f"mesh (a): dry run {name} exited {code}, status {rec['status']}: "
                 + "\n".join(tail))
        mem = rec["memory"]
        per_device = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        recs[name] = {k: rec[k] for k in ("n_devices", "n_layers", "trace_s", "memory", "flops",
                                          "flops_per_device", "bytes_accessed", "collectives",
                                          "wire_bytes")}
        recs[name]["wall_s"] = time.perf_counter() - run["t0"]
        recs[name]["per_device_bytes"] = per_device
        print(f"mesh (a) dry run {name}: {rec['n_devices']} devices, {rec['n_layers']} layers, "
              f"per device: arguments {mem['argument_size_in_bytes'] / 1e9:.3f} GB, outputs "
              f"{mem['output_size_in_bytes'] / 1e9:.3f} GB, temp {mem['temp_size_in_bytes'] / 1e9:.3f}"
              f" GB (arguments + temp {per_device / 1e9:.3f} GB; this card holds "
              f"{total / 1e9:.3f} GB); trace {rec['trace_s']:.1f} s; flops {rec['flops']:.4g}, "
              f"per device {rec['flops_per_device']:.4g}; collectives "
              f"{json.dumps(rec['collectives'])}", flush=True)
    return recs


def _serve_steps(prefill, decode, params, batch, steps: int):
    """A prefill then ``steps`` greedy decode steps; every step's logits,
    whole (a DTensor's gathered)."""
    from torch.distributed.tensor import DTensor

    whole = lambda t: t.full_tensor() if isinstance(t, DTensor) else t
    logits, cache = prefill(params, batch)
    out = [whole(logits)]
    for _ in range(steps):
        logits, cache = decode(params, cache, logits.argmax(-1)[:, None])
        out.append(whole(logits))
    return out


def sharded_serving(device) -> dict:
    """Phase 16 (b): Qwen3-MoE-235B-A22B at its published width, bf16,
    ``EP_LAYERS`` of its 94 layers, on a (1, 1) (data, model) mesh over a
    one-process NCCL group on the card (``make_host_mesh``), its parameters
    distributed by ``param_shardings`` (DTensors) and the tokens by
    ``batch_sharding``: a prefill of ``EP_BATCH`` x ``EP_PROMPT`` tokens and
    ``MESH_DECODE_STEPS`` greedy decode steps, whose logits must equal the
    unsharded steps' bit for bit, with K3 launched as often; every K3 launch
    of one sharded prefill and decode step against its plain version (bf16
    rule); the sharded and unsharded steps timed (the host cost of DTensor);
    K3 timed at the sharded prefill's up projection."""
    import torch
    import torch.distributed as dist
    import repro_torch.kernels.moe_gemm as k3_mod
    from repro_torch.kernels.moe_gemm import moe_gemm
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_params
    from repro_torch.models import sharding as sh
    from repro_torch.training import make_decode_step, make_prefill_step

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = _ep_config()
    params = init_params(cfg, 0, device=device)
    batch = _ep_batch(cfg, device)
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    _serve_steps(prefill, decode, params, batch, 1)  # warm-up
    reset_launches()
    want = _serve_steps(prefill, decode, params, batch, MESH_DECODE_STEPS)
    torch.cuda.synchronize()
    want_launches = {k: v for k, v in moe_gemm.launches.items() if v}
    plain_prefill_ms = timed_ms(lambda: prefill(params, batch), 3)
    _, plain_cache = prefill(params, batch)
    tok = want[0].argmax(-1)[:, None]
    plain_decode_ms = timed_ms(lambda: decode(params, {k: v.clone() for k, v in
                                                       plain_cache.items()}, tok), 3)
    phase("mesh (b) unsharded steps", t0)

    mesh = make_host_mesh(model=1)
    try:
        rec = {"mesh": list(mesh.shape), "backend": dist.get_backend(), "n_layers": cfg.n_layers,
               "batch": EP_BATCH, "prompt": EP_PROMPT, "decode_steps": MESH_DECODE_STEPS}
        dparams = sh.distribute_params(params, mesh, sh.param_shardings(cfg, mesh))
        dbatch = {k: sh.distribute(v, sh.batch_sharding(mesh, v.shape[0], v.ndim))
                  for k, v in batch.items()}
        dprefill = make_prefill_step(cfg)
        ddecode = make_decode_step(cfg)
        _serve_steps(dprefill, ddecode, dparams, dbatch, 1)  # warm-up
        reset_launches()
        got = _serve_steps(dprefill, ddecode, dparams, dbatch, MESH_DECODE_STEPS)
        torch.cuda.synchronize()
        launches = {k: v for k, v in moe_gemm.launches.items() if v}
        if launches != want_launches or launches != {
                "expert_wgmma": 3 * cfg.n_layers * (1 + MESH_DECODE_STEPS)}:
            fail(f"mesh (b): K3 launches {launches} sharded, {want_launches} unsharded")
        equal = [bool(torch.equal(g, w)) for g, w in zip(got, want)]
        if not all(equal):
            diff = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
            fail(f"mesh (b): sharded logits not bit for bit the unsharded ones ({equal}; "
                 f"max |diff| {diff})")
        rec.update(bitwise_equal_steps=len(equal), k3_launches=launches,
                   logits_finite=bool(all(g.isfinite().all() for g in got)))
        rec["prefill_ms"] = timed_ms(lambda: dprefill(dparams, dbatch), 3)
        _, dcache = dprefill(dparams, dbatch)
        dtok = sh.distribute(tok, sh.batch_sharding(mesh, EP_BATCH, 2))
        rec["decode_ms"] = timed_ms(lambda: ddecode(dparams, {k: v.clone() for k, v in
                                                              dcache.items()}, dtok), 3)
        rec["unsharded_prefill_ms"], rec["unsharded_decode_ms"] = plain_prefill_ms, plain_decode_ms
        phase("mesh (b) sharded steps", t0)

        checks, keep = [], {}
        real = k3_mod.moe_gemm
        try:
            k3_mod.moe_gemm = k3_checked(checks, keep, "mesh prefill", real)
            logits, dcache = dprefill(dparams, dbatch)
            k3_mod.moe_gemm = k3_checked(checks, keep, "mesh decode", real)
            ddecode(dparams, dcache, logits.argmax(-1)[:, None])
        finally:
            k3_mod.moe_gemm = real
        if len(checks) != 6 * cfg.n_layers or any(
                c["launches"] != {"expert_wgmma": 1} for c in checks):
            fail(f"mesh (b): K3 calls {[(c['x'], c['launches']) for c in checks]}")
        err = max(c["max_abs_err"] for c in checks)
        rec["k3_checks"] = checks
        rec["k3"] = k3_record_at(*keep["mesh prefill"], launches["expert_wgmma"], err)
        rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    finally:
        dist.destroy_process_group()
    rec["phase_s"] = time.perf_counter() - t0
    print("mesh (b) sharded serving", json.dumps({k: v for k, v in rec.items()
                                                  if k != "k3_checks"}), flush=True)
    return rec


EXAMPLES = ROOT / "examples_torch"  # phase 17: the reference's six examples, for the port
MCL_SCALE = 0.2  # 17 (a): MCL-dip at the quickstart's own scale
DECODE_BATCH, DECODE_PROMPT, DECODE_TOKENS = 4, 64, 32  # 17 (e): the example's defaults
DECODE_ARCHS = ("internlm2-1.8b", LM_ARCH)  # 17 (e): full depth; Qwen3-MoE at LM_LAYERS
TRAIN_100M_STEPS = 200  # 17 (f): the example's run (its script's default is 300)
TRAIN_100M_STOP = 120  # 17 (f): the stopped run's last step
TRAIN_100M_WARMUP = 5  # 17 (f): steps left out of the median step time
TRAIN_100M_RESUME_TOL = 1e-5  # 17 (f), absolute, on every loss from the resumed step on


def example(name: str):
    """``examples_torch/<name>.py`` as a fresh module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def quietly(fn, *args, **kwargs):
    """(``fn``'s result, what it printed)."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args, **kwargs)
    return result, out.getvalue()


class _Stop(Exception):
    """Ends 17 (f)'s stopped run: not retryable, so ``run_loop`` re-raises
    it and writes no checkpoint for the steps since its last one."""


def examples_spgemm(device, rng) -> dict:
    """Phase 17 (a)-(c): the SpGEMM examples on the card.

    (a) ``quickstart.run`` on MCL-dip at scale 0.2 (networkx's
        Barabási–Albert graph built without networkx), all seven models and
        ``auto`` planned at p = 4 and ``auto`` executed on the card by the
        example; then ``auto``'s and the monoC handle's products through
        ``front_door_run`` against scipy in float64 (1e-4), K1 launched on
        monoC, monoC's planned words equal to its predicted, and K1 timed
        at the monoC call's own inputs;
    (b) ``select_quickstart.run`` on 27-AP at n = 6: measured words equal
        to predicted on every model, each executor's error, and the
        compile-once demo's ten products against float64 with no LRU miss
        after its compile;
    (c) ``amg_partition_study.main`` at its defaults (n = 9, p = 8) with
        ``--device cuda`` and with ``--device cpu``: the same tables."""
    import torch
    from repro_torch.core.matrices import amg_instances, mcl_instance
    from repro_torch.kernels.bsr_spgemm import bsr_spgemm_local

    rec = {}
    t0 = time.perf_counter()
    inst = mcl_instance("dip", MCL_SCALE)
    res, out = quietly(example("quickstart").run, inst, p=P, device=device)
    print(out, end="", flush=True)
    handles = res["handles"]
    rec["quickstart"] = {
        "instance": inst.name, "scale": MCL_SCALE, "shape": list(inst.shape),
        "nnz": [inst.a.nnz, inst.b.nnz, inst.c.nnz], "n_mult": inst.n_mult,
        "plan_s": time.perf_counter() - t0, "auto_model": handles["auto"].model,
        "example_max_abs_err": res["max_abs_err"], "stdout": out,
        "table": {m: {k: h.cost_report()[k] for k in ("predicted_words", "planned_words",
                                                        "predicted_max_part")}
                  for m, h in handles.items()},
    }
    if not res["max_abs_err"] <= 1e-4 * max(1.0, float(np.abs(res["c"]).max())):
        fail(f"examples (a): the example's product is off A @ B by {res['max_abs_err']}")
    runs = {}
    for model in ("auto", "monoC"):
        exe, last, stats = front_door_run(inst, model, device, rng, handle=handles[model])
        runs[model] = (exe, last, stats)
        rec["quickstart"][model] = stats
    stats = runs["monoC"][2]
    k1_launches = stats["kernel_launches"].get("scalar_runs", 0)
    if k1_launches < REPS:
        fail(f"examples (a): K1 launched {stats['kernel_launches']} in {REPS} monoC calls")
    if stats["planned_words"] != stats["predicted_words"]:
        fail(f"examples (a): monoC plans {stats['planned_words']} words, predicted "
             f"{stats['predicted_words']}")
    exe, (a_last, b_last), _ = runs["monoC"]
    library_ms = library_csr_ms(csr_on_card(inst.a, a_last, device),
                                csr_on_card(inst.b, b_last, device))
    rec["k1"] = kernel_record_at(exe, a_last, b_last, library_ms)
    rec["k1"]["launches"] = k1_launches
    del runs, exe
    print("examples (a) quickstart", json.dumps({k: v for k, v in rec["quickstart"].items()
                                                 if k not in ("stdout", "table")}), flush=True)
    print("examples (a) K1 at MCL-dip monoC", json.dumps(rec["k1"]), flush=True)
    phase("examples (a) quickstart", t0)

    t0 = time.perf_counter()
    ap6 = amg_instances(6)[0]
    res, out = quietly(example("select_quickstart").run, ap6, p=P, device=device)
    print(out, end="", flush=True)
    for r in res["records"]:
        if r["measured_words"] != r["predicted_words"] or not r["exec_max_err"] <= 1e-4:
            fail(f"examples (b): {r['model']} measured {r['measured_words']} words, predicted "
                 f"{r['predicted_words']}, executor err {r['exec_max_err']}")
    demo = res["iterated"]
    if demo["lru_misses"] != 0 or len(demo["products"]) != 10:
        fail(f"examples (b): {demo['lru_misses']} LRU misses over {len(demo['products'])} calls")
    demo_err = max(check_product(ap6, c, a, b, device, "examples (b) compile-once product")
                   for a, b, c in demo["products"])
    rec["select_quickstart"] = {
        "instance": ap6.name, "stdout": out, "demo_max_abs_err": demo_err,
        "records": [{k: v for k, v in r.items() if k != "name"} for r in res["records"]],
        "demo": {k: demo[k] for k in ("compile_s", "call_us", "calls", "lru_misses")},
    }
    print("examples (b) select_quickstart", json.dumps(rec["select_quickstart"]["demo"]),
          flush=True)
    phase("examples (b) select_quickstart", t0)

    t0 = time.perf_counter()
    study = example("amg_partition_study")
    card, card_out = quietly(study.main, ["--device", "cuda"])
    host, host_out = quietly(study.main, ["--device", "cpu"])
    print(card_out, end="", flush=True)
    if card_out != host_out or card != host:
        fail("examples (c): the study's tables differ between --device cuda and cpu")
    rec["amg_partition_study"] = {"stdout": card_out,
                                  "max_part_cost": {"/".join(k): v for k, v in card.items()}}
    phase("examples (c) amg_partition_study", t0)
    torch.cuda.empty_cache()
    return rec


def k3_main_launches(launches: dict) -> int:
    """The GEMM launches of K3 (``expert_wgmma`` or ``expert_split``), not
    its copies: one a product."""
    return launches.get("expert_wgmma", 0) + launches.get("expert_split", 0)


def examples_lm(device) -> dict:
    """Phase 17 (d)-(f): the LM examples on the card.

    (d) ``moe_comm_planning.run`` (16-expert smoke Qwen3-MoE, fp32, the
        planned placement installed): 3 K3 products a MoE layer in the
        call, each held to its plain version; the loss finite and within
        1e-4 of the same example on the CPU with the same weights;
    (e) ``transformer_decode.generate`` (4 x 64 prompts, 32 tokens, greedy)
        on internlm2-1.8b at its published width and depth and on
        Qwen3-MoE-235B-A22B at its published width, ``LM_LAYERS`` layers
        (K3 3 times a MoE layer a call, 1 prefill and 31 decode steps, each
        launch of a 3-token run held to its plain version): the second
        call's prefill ms and decode tokens/s, the tokens equal across the
        two calls;
    (f) ``train_100m.main`` (the ~100M internlm2-family decoder, fp32,
        4 x 256 tokens a step, AdamW, a checkpoint every 50 steps) for 200
        steps in a fresh directory: loss finite and gradient norm > 0 at
        every logged step, step 199's loss below ln 16,384 and at least 1
        nat below step 0's; then in a second directory a run stopped
        before step 121 (last checkpoint: step 100), and ``main`` again on
        that directory, which must resume there, its losses within 1e-5 of
        the uninterrupted run's.  Step ms (median after ``TRAIN_100M_WARMUP``
        steps), tokens/s, peak memory, the loss at every 50th step."""
    import dataclasses
    import math
    import tempfile

    import torch
    import repro_torch.kernels.moe_gemm as k3_mod
    from repro_torch.configs import get_config
    from repro_torch.kernels.moe_gemm import moe_gemm
    from repro_torch.models import init_params

    rec = {}
    real = k3_mod.moe_gemm
    t0 = time.perf_counter()
    planning = example("moe_comm_planning")
    cfg = planning.smoke_moe_config()
    params = init_params(cfg, 0, device=device)
    reset_launches()
    res, out = quietly(planning.run, cfg, params)
    launches = {k: v for k, v in moe_gemm.launches.items() if v}
    n_moe = cfg.n_layers
    if k3_main_launches(launches) != 3 * n_moe:
        fail(f"examples (d): K3 launches {launches} in the call, not 3 a MoE layer ({n_moe})")
    cpu_res, _ = quietly(planning.run, cfg, _tree_to(params, torch.device("cpu")))
    if not (math.isfinite(res["loss"]) and abs(res["loss"] - cpu_res["loss"]) <= 1e-4):
        fail(f"examples (d): loss {res['loss']} on the card, {cpu_res['loss']} on the CPU")
    checks, keep = [], {}
    try:
        k3_mod.moe_gemm = k3_checked(checks, keep, "moe planning", real)
        quietly(planning.run, cfg, params)
    finally:
        k3_mod.moe_gemm = real
    err = max(c["max_abs_err"] for c in checks)
    rec["moe_comm_planning"] = {
        "stdout": out, "loss": res["loss"], "cpu_loss": cpu_res["loss"], "k3_launches": launches,
        "placement": res["plan"].placement.tolist(), "k3_checks": checks}
    rec["k3_moe"] = k3_record_at(*keep["moe planning"], k3_main_launches(launches), err)
    print(out, end="", flush=True)
    print("examples (d) moe_comm_planning", json.dumps(rec["k3_moe"]), flush=True)
    del params
    phase("examples (d) moe_comm_planning", t0)

    decode = example("transformer_decode")
    rec["decode"] = {}
    for arch in DECODE_ARCHS:
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = get_config(arch)
        cfg = base if arch != LM_ARCH else dataclasses.replace(base, n_layers=LM_LAYERS)
        params, _ = decode.load(cfg, 0, device)
        prompts = np.random.default_rng(0).integers(
            0, cfg.vocab, (DECODE_BATCH, DECODE_PROMPT)).astype(np.int32)
        first = decode.generate(cfg, params, prompts, DECODE_TOKENS)  # warm-up
        reset_launches()
        run = decode.generate(cfg, params, prompts, DECODE_TOKENS)
        launches = {k: v for k, v in moe_gemm.launches.items() if v}
        toks, logits = run["tokens"], run["prefill_logits"]
        same = bool(torch.equal(toks, first["tokens"]))
        if (tuple(toks.shape) != (DECODE_BATCH, DECODE_TOKENS) or not same
                or not bool(logits.isfinite().all()) or int(toks.min()) < 0
                or int(toks.max()) >= cfg.vocab):
            fail(f"examples (e) {arch}: tokens {tuple(toks.shape)} (equal across calls: "
                 f"{same}), logits finite {bool(logits.isfinite().all())}")
        steps = DECODE_TOKENS - 1
        r = {"n_layers": cfg.n_layers, "n_layers_published": base.n_layers, "dtype": cfg.dtype,
             "batch": DECODE_BATCH, "prompt": DECODE_PROMPT, "tokens": DECODE_TOKENS,
             "prefill_ms": run["prefill_s"] * 1e3,
             "decode_ms_per_step": run["decode_s"] * 1e3 / steps,
             "decode_tokens_per_s": DECODE_BATCH * steps / run["decode_s"],
             "first_sequence": toks[0, :16].tolist(), "k3_launches": launches,
             "param_bytes": _tree_bytes(params)}
        if arch == LM_ARCH:
            if launches != {"expert_wgmma": 3 * LM_LAYERS * DECODE_TOKENS}:
                fail(f"examples (e) {arch}: K3 launches {launches} in one call, not "
                     f"3 a layer a step ({3 * LM_LAYERS * DECODE_TOKENS})")
            checks, keep = [], {}
            try:
                k3_mod.moe_gemm = k3_checked(checks, keep, "decode example", real)
                decode.generate(cfg, params, prompts, 3)
            finally:
                k3_mod.moe_gemm = real
            if len(checks) != 9 * LM_LAYERS:
                fail(f"examples (e): {len(checks)} K3 calls in a 3-token run")
            err = max(c["max_abs_err"] for c in checks)
            r["k3_checks"] = checks
            rec["k3_decode"] = k3_record_at(*keep["decode example"], launches["expert_wgmma"], err)
            del keep  # its w views hold the whole expert stacks
        elif launches:
            fail(f"examples (e) {arch}: a dense model launched K3 {launches}")
        r["peak_bytes"] = torch.cuda.max_memory_allocated()
        rec["decode"][arch] = r
        del params, first, run
        print(f"examples (e) decode {arch}", json.dumps(
            {k: v for k, v in r.items() if k != "k3_checks"}), flush=True)
        phase(f"examples (e) transformer_decode {arch}", t0)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    train = example("train_100m")
    OUT.mkdir(exist_ok=True)
    logs = {tag: OUT / f"train_100m{tag}.jsonl" for tag in ("", "_resumed")}
    for log in logs.values():
        log.unlink(missing_ok=True)
    uniform = math.log(train.model_100m().vocab)
    with tempfile.TemporaryDirectory(prefix="train_100m_") as tmp:
        argv = lambda tag: ["--steps", str(TRAIN_100M_STEPS), "--ckpt-dir",
                            f"{tmp}/ckpt{tag}", "--log", str(logs[tag]), "--device", "cuda"]
        torch.cuda.reset_peak_memory_stats()
        whole, out = quietly(train.main, argv(""))
        peak = torch.cuda.max_memory_allocated()
        phase(f"examples (f) train_100m, {TRAIN_100M_STEPS} steps", t0)

        def stop(step):
            if step == TRAIN_100M_STOP + 1:
                raise _Stop(f"stopped before step {step}")

        try:
            quietly(train.train, train.model_100m(), train.parse_args(argv("_resumed")),
                    device, failure_injector=stop)
            fail("examples (f): the stopped run did not stop")
        except _Stop:
            pass
        from repro_torch.checkpoint import latest_step

        stopped_at = latest_step(f"{tmp}/ckpt_resumed")
        resumed, resumed_out = quietly(train.main, argv("_resumed"))
    losses = whole["losses"]
    if sorted(losses) != list(range(TRAIN_100M_STEPS)) or whole["stats"].restarts:
        fail(f"examples (f): the run ran steps {sorted(losses)[:3]}.. with "
             f"{whole['stats'].restarts} restarts")
    for r in whole["records"]:
        if not (math.isfinite(r["loss"]) and r["grad_norm"] > 0):
            fail(f"examples (f): logged step {r}")
    last, first_loss = losses[TRAIN_100M_STEPS - 1], losses[0]
    if not (last < uniform and last <= first_loss - 1.0):
        fail(f"examples (f): step {TRAIN_100M_STEPS - 1} loss {last}, step 0 loss {first_loss}, "
             f"uniform {uniform}")
    start = TRAIN_100M_STOP // train.CKPT_EVERY * train.CKPT_EVERY
    if stopped_at != start or sorted(resumed["losses"]) != list(range(start, TRAIN_100M_STEPS)):
        fail(f"examples (f): stopped with checkpoint {stopped_at}, resumed at "
             f"{min(resumed['losses'], default=None)}, not {start}")
    resume_err = max(abs(resumed["losses"][i] - losses[i])
                     for i in range(start, TRAIN_100M_STEPS))
    if not resume_err <= TRAIN_100M_RESUME_TOL:
        fail(f"examples (f): the resumed run's losses are off the uninterrupted run's by "
             f"{resume_err}")
    times = whole["stats"].step_times[TRAIN_100M_WARMUP:]
    step_ms = statistics.median(times) * 1e3
    cfg, defaults = train.model_100m(), train.parse_args([])
    tokens = defaults.global_batch * defaults.seq_len
    # where a step's device time goes, on the trained state (updated in place)
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.step import make_train_step

    step = make_train_step(cfg, lr=defaults.lr)
    data = SyntheticTokens(cfg.vocab, defaults.seq_len, defaults.global_batch, seed=0)
    batch = {k: torch.as_tensor(v, device=device) for k, v in data.batch(0).items()}
    profile = profile_fn(lambda: step(whole["params"], whole["opt"], batch), step_ms, calls=2,
                         label="train_100m step")
    rec["train_100m"] = {
        "config": dataclasses.asdict(cfg), "param_count": sum(
            p.numel() for p in tree_leaves(whole["params"])),
        "steps": TRAIN_100M_STEPS, "tokens_per_step": tokens, "step_ms_median": step_ms,
        "step_ms_p90": float(np.percentile(times, 90)) * 1e3,
        "tokens_per_s": tokens / (step_ms / 1e3), "peak_bytes": peak, "profile": profile,
        "uniform_nll": uniform,
        "loss_every_50": {i: losses[i] for i in range(0, TRAIN_100M_STEPS, 50)},
        "loss_last": last, "records": whole["records"], "stdout_tail": out[-2000:],
        "resume": {"stopped_after": TRAIN_100M_STOP, "checkpoint": stopped_at,
                   "steps_run": resumed["stats"].steps_run, "max_abs_loss_diff": resume_err,
                   "tol": TRAIN_100M_RESUME_TOL, "stdout_tail": resumed_out[-1000:]},
    }
    print("examples (f) train_100m", json.dumps(
        {k: v for k, v in rec["train_100m"].items()
         if k not in ("records", "stdout_tail", "config")}), flush=True)
    phase("examples (f) train_100m", t0)
    return rec


def examples(device, rng) -> dict:
    """Phase 17: the six examples of ``examples_torch/`` on the card
    (``examples_spgemm``, ``examples_lm``)."""
    t0 = time.perf_counter()
    rec = {**examples_spgemm(device, rng), **examples_lm(device)}
    rec["phase_s"] = time.perf_counter() - t0
    return rec


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
    exe_ptap, _, ptap_stats = main_path_block1(ptap, device, rng)
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
    k1_paper = k1_paper_sizes(device, rng)
    phase("K1 at the paper's sizes", t0)

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
    models, lp, handles = every_model(ap, ptap, ptap_stats, device, rng)
    handles[(ptap, "monoC")] = exe_ptap.planned
    del exe_ptap
    phase("every model", t0)

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    served = serving(device, rng)
    phase("serving", t0)

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    summa_device = summa_and_device_engine(ap, ptap, lp, ap_stats, ptap_stats, models,
                                           device, rng)
    phase("summa2d and the device partitioner", t0)

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    lm = lm_serving(device)
    phase("LM serving", t0)

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    ranks = ranks_in_processes(handles, device, rng, served)
    phase("ranks in processes", t0)

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    train = training(device)
    phase("training", t0)

    dryrun_procs = start_dry_runs()  # phase 16 (a), on the host's cores beside phase 15
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    ssm_rec = ssm(device)
    phase("Mamba and hybrid layers", t0)

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    mesh_rec = {"dryrun": dry_runs(dryrun_procs, device)}
    phase("mesh (a) dry runs", t0)
    mesh_rec["serve"] = sharded_serving(device)
    phase("mesh and dry run", t0)

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    ex = examples(device, rng)
    phase("examples", t0)

    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps({
        "card": card_line, "ap": ap_stats, "ptap": ptap_stats, "k1_ap": scalar,
        "block16": block16_stats, "k1_block16": blocked, "k1_shapes": shape_checks,
        "k1_retiled": retiled, "k1_paper": k1_paper, "k2_amg": spmm, "k3_qwen3_moe": moe,
        "every_model": models,
        "serving": served, "summa_device": summa_device, "lm_serve": lm, "ranks": ranks,
        "train": train, "ssm": ssm_rec, "mesh": mesh_rec, "examples": ex,
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
        ("moe_gemm/split3_bf16_t@fp32_up_grad", "moe_gemm.cu", k3,
         moe["grad_fp32"]["split3_bf16_t"]),
        ("moe_gemm/expert_split@fp32_up_dx", "moe_gemm.cu", k3,
         moe["grad_fp32"]["expert_split_dx"]),
        ("moe_gemm/expert_split@fp32_up_dw", "moe_gemm.cu", k3,
         moe["grad_fp32"]["expert_split_dw"]),
        ("moe_gemm/expert_wgmma@lm_prefill", "moe_gemm.cu", k3, lm["k3"]["prefill"]),
        ("moe_gemm/expert_wgmma@lm_decode", "moe_gemm.cu", k3, lm["k3"]["decode"]),
        ("bsr_spgemm/scalar_runs@ranks", "bsr_spgemm.cu", k1, ranks["k1"]),
        ("moe_gemm/expert_wgmma@ranks_ep", "moe_gemm.cu", k3, ranks["k3"]),
        ("bsr_spgemm/scalar_runs@ranks_batched", "bsr_spgemm.cu", k1, ranks["k1_batched"]),
        ("moe_gemm/expert_wgmma@ranks_ep_decode", "moe_gemm.cu", k3, ranks["k3_decode"]),
        ("moe_gemm/expert_wgmma@train", "moe_gemm.cu", k3, train["k3"]["forward"]),
        ("moe_gemm/expert_wgmma_dx@train", "moe_gemm.cu", k3, train["k3"]["dx"]),
        ("moe_gemm/expert_wgmma_dw@train", "moe_gemm.cu", k3, train["k3"]["dw"]),
        ("moe_gemm/split3_bf16_t@train_fp32", "moe_gemm.cu", k3,
         train["k3"]["split3_bf16_t"]),
        ("moe_gemm/expert_split@train_fp32_dx", "moe_gemm.cu", k3,
         train["k3"]["expert_split_dx"]),
        ("moe_gemm/expert_split@train_fp32_dw", "moe_gemm.cu", k3,
         train["k3"]["expert_split_dw"]),
        ("moe_gemm/expert_wgmma@mesh", "moe_gemm.cu", k3, mesh_rec["serve"]["k3"]),
        ("bsr_spgemm/scalar_runs@mcl", "bsr_spgemm.cu", k1, ex["k1"]),
        ("bsr_spgemm/scalar_runs@mcl_facebook", "bsr_spgemm.cu", k1, k1_paper["mcl_facebook"]),
        ("bsr_spgemm/scalar_runs@amg63", "bsr_spgemm.cu", k1, k1_paper["amg63"]),
        ("moe_gemm/expert_split@examples_moe", "moe_gemm.cu", k3, ex["k3_moe"]),
        ("moe_gemm/expert_wgmma@examples_decode", "moe_gemm.cu", k3, ex["k3_decode"]),
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
