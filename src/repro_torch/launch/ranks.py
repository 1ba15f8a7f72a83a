"""Ranks in their own processes: ``run_ranks(fn, p, device=..., workdir=...)``.

Starts p processes with the ``spawn`` start method (CUDA needs it), joins
them in one gloo process group initialised through a file under
``workdir`` (no fixed port: test runs share the host), and calls
``fn(group, device, *args)`` in each, where ``group`` is the whole group
and ``torch.distributed.get_rank(group)`` the process's rank.  Each child
runs on one CPU thread.  The call returns every rank's result with the
kernel launches it counted, in rank order; a child that raises, or dies,
fails the call with its traceback, and the other children are stopped.

On one card, every rank shares the card and gloo moves the bytes through
the host (``comm.GroupComm`` stages them); NCCL refuses two ranks on one
device.  ``fn`` and ``args`` are pickled to the children, so ``fn`` is a
module-level function of an importable module.
"""
from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import queue
import time
import traceback
from pathlib import Path
from typing import Any, Callable

import torch

__all__ = ["RankResult", "kernel_launches", "run_ranks"]

#: a collective waits this long for a peer before it fails
GROUP_TIMEOUT = datetime.timedelta(seconds=600)


@dataclasses.dataclass
class RankResult:
    """What one rank's process returned, and the kernel launches it made
    (``kernel_launches()`` after ``fn``)."""

    rank: int
    result: Any
    launches: dict[str, dict[str, int]]


def kernel_launches() -> dict[str, dict[str, int]]:
    """This process's launch counts of every kernel wrapper, by library
    and ``__global__``."""
    from repro_torch.kernels.bsr_spgemm import bsr_spgemm_local
    from repro_torch.kernels.bsr_spmm import bsr_spmm_local
    from repro_torch.kernels.moe_gemm import moe_gemm

    return {
        "bsr_spgemm": dict(bsr_spgemm_local.launches),
        "bsr_spmm": dict(bsr_spmm_local.launches),
        "moe_gemm": dict(moe_gemm.launches),
    }


def _rank_main(fn, rank: int, p: int, device: str, init: str, args: tuple, results) -> None:
    """A child: join the group, run ``fn``, report its result or traceback."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            "gloo", init_method=f"file://{init}", rank=rank, world_size=p,
            timeout=GROUP_TIMEOUT,
        )
        out = fn(dist.group.WORLD, dev, *args)
        results.put((rank, True, RankResult(rank, out, kernel_launches())))
    except Exception:  # the boundary of the child: report, the parent raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(
    fn: Callable,
    p: int,
    *,
    device,
    workdir,
    args: tuple = (),
    timeout: float = 1800.0,
) -> list[RankResult]:
    """Run ``fn(group, device, *args)`` in p processes, one rank each, and
    return their ``RankResult``s in rank order.

    ``device`` is where every rank runs (``"cpu"``, or the card: all ranks
    share it); a card that is not there raises.  The kernels are built here
    once before the children start, so they never race to compile the same
    source.  ``workdir`` (created if need be) holds the group's init file.
    Raises ``RuntimeError`` with the child's traceback when a rank raises
    or exits without a result, and ``TimeoutError`` past ``timeout``
    seconds; the other children are then terminated.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("run_ranks on the card, but no CUDA device is available")
        from repro_torch.kernels import _build

        _build.build_all()
        if dev.index is None:
            dev = torch.device("cuda", 0)
    workdir = Path(workdir).resolve()  # file:// takes an absolute path
    workdir.mkdir(parents=True, exist_ok=True)
    init = workdir / "pg"
    init.unlink(missing_ok=True)  # a stale store would join an old group
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [
        ctx.Process(target=_rank_main, args=(fn, rank, p, str(dev), str(init), args, results))
        for rank in range(p)
    ]
    for proc in procs:
        proc.start()
    out: list[RankResult | None] = [None] * p
    deadline = time.monotonic() + timeout
    try:
        # drain the queue before any join: a child blocks until its result
        # is read
        while any(r is None for r in out):
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                for rank, proc in enumerate(procs):
                    if out[rank] is None and proc.exitcode is not None:
                        raise RuntimeError(
                            f"rank {rank} of {p} exited with code {proc.exitcode} "
                            f"and no result"
                        ) from None
                if time.monotonic() > deadline:
                    raise TimeoutError(f"run_ranks: {p} ranks not done in {timeout} s") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {p} failed:\n{payload}")
            out[rank] = payload
    finally:
        done = all(r is not None for r in out)
        for proc in procs:
            if not done:
                proc.terminate()
            proc.join(timeout=60)
            if proc.is_alive():
                proc.kill()
                proc.join()
        results.close()
        init.unlink(missing_ok=True)
    return out
