"""Executor phase: the monochrome-C SpGEMM (Ex. 5.4) in PyTorch.

Every C (block-)nonzero lives on one rank; the cut A-nets and B-nets lower
to two padded all_to_all expand phases, and local compute streams the
plan's pair lists through the BSR SpGEMM kernel, so the executor's
arithmetic is exactly the coarsened multiplication vertices the model
counts.  This mirrors ``repro.distributed.spgemm_exec``'s monoC executor
with the p ranks stacked on one device (``comm.Loopback``).

Structure-time vs value-time split (DESIGN.md §8): ``MonoCStep`` uploads
the route tables, the flattened pair lists and their run offsets once; its
call takes rank-major packed operand tables.  The dense entry point
``monoC_spgemm`` is a thin wrapper over ``runtime.compile_spgemm``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed.comm import Loopback
from repro_torch.distributed.plan_ir import MonoCPlan
from repro_torch.kernels.bsr_spgemm import bsr_spgemm_local, pair_runs


def _take0(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather leading-axis slices with -1 padding -> zero slices."""
    rows = x[idx.clamp(min=0)]
    mask = (idx >= 0).reshape(idx.shape + (1,) * (x.ndim - 1))
    return torch.where(mask, rows, torch.zeros((), dtype=x.dtype, device=x.device))


def _int32(x: np.ndarray, device) -> torch.Tensor:
    x = np.asarray(x)
    if len(x) and x.max() > np.iinfo(np.int32).max:
        raise ValueError("index exceeds the kernel's int32 range")
    return torch.as_tensor(x.astype(np.int32), device=device)


class MonoCStep:
    """The monochrome-C executor core for one plan on one device.

    ``step(a_own, b_own)`` takes rank-major packed block tables
    ((p, N_max, b, b)) and returns rank-major C block slots
    (p, C_max + 1, b, b); the trailing slot per rank is the padding sink
    and stays zero.  Local compute is ONE kernel launch over all p ranks'
    pairs: rank d's table slots are offset by d times the per-rank table
    size, and the padding pairs (which only ever hit the all-zero operand
    slots and the garbage C slot) are dropped.
    """

    def __init__(self, plan: MonoCPlan, block: int, device):
        p = plan.p
        self.p, self.block, self.device = p, block, torch.device(device)
        self.comm = Loopback(p)
        self.n_c_slots = plan.n_c_slots
        self._routes = []
        for op in ("a", "b"):
            send = plan.routes[f"expand_{op}"].send_idx  # (p, p, T) local slots
            n_own = plan.local_ids[f"{op}_nz"].shape[1]
            src = np.arange(p, dtype=np.int64)[:, None, None]
            flat = np.where(send >= 0, src * n_own + send, -1)
            self._routes.append(
                (
                    torch.as_tensor(flat.reshape(-1), device=self.device),
                    int((send >= 0).sum()),
                    send.shape[2],
                )
            )
        # one pair list over the stacked tables, without the padding pairs
        rank = np.arange(p, dtype=np.int64)[:, None]
        pc_local = plan.compute["pair_c"]
        keep = (pc_local != plan.n_c_slots - 1).ravel()
        pa = (plan.compute["pair_a"] + rank * plan.a_table_slots).ravel()[keep]
        pb = (plan.compute["pair_b"] + rank * plan.b_table_slots).ravel()[keep]
        pc = (pc_local + rank * plan.n_c_slots).ravel()[keep]
        run_start, run_c = pair_runs(pc)
        self.pair_a, self.pair_b, self.pair_c = (
            _int32(x, self.device) for x in (pa, pb, pc)
        )
        self.run_start = _int32(run_start, self.device)
        self.run_c = _int32(run_c, self.device)
        self.n_c_blocks = p * plan.n_c_slots

    def _expand(self, own: torch.Tensor, route) -> torch.Tensor:
        """``[owned | received | zero]`` slot tables of all ranks, flattened
        rank-major to (p * table_slots, b, b)."""
        flat_idx, n_items, T = route
        p, n_own, b = own.shape[0], own.shape[1], self.block
        buf = _take0(own.reshape(p * n_own, b, b), flat_idx).reshape(p, p, T, b, b)
        # THE cut-net traffic of this operand
        recv = self.comm.all_to_all(buf, n_items)
        zero = own.new_zeros((p, 1, b, b))
        return torch.cat([own, recv.reshape(p, p * T, b, b), zero], 1).reshape(-1, b, b)

    def kernel_inputs(self, a_own: torch.Tensor, b_own: torch.Tensor) -> tuple:
        """The arguments of the step's one ``bsr_spgemm_local`` launch."""
        return (
            self._expand(a_own, self._routes[0]),
            self._expand(b_own, self._routes[1]),
            self.pair_a,
            self.pair_b,
            self.pair_c,
            self.run_start,
            self.run_c,
            self.n_c_blocks,
        )

    def __call__(self, a_own: torch.Tensor, b_own: torch.Tensor) -> torch.Tensor:
        c = bsr_spgemm_local(*self.kernel_inputs(a_own, b_own))
        return c.reshape(self.p, self.n_c_slots, self.block, self.block)


def make_monoC_step(plan: MonoCPlan, device, block: int = 8) -> MonoCStep:
    """The monoC executor core (``repro``'s ``make_monoC_step``), with the
    plan's tables uploaded to ``device`` once."""
    return MonoCStep(plan, block, device)


def monoC_spgemm(
    a_dense: np.ndarray,
    b_dense: np.ndarray,
    plan: MonoCPlan,
    device=None,
    block: int = 8,
) -> torch.Tensor:
    """2D sparsity-dependent monochrome-C SpGEMM (Ex. 5.4).

    ``plan`` must have been built on the b x b block structures of the
    operands (``plan_ir.plan_monoC_from_dense`` does both steps).  Runs on
    the card unless ``device`` names another (``"cpu"`` runs the plain
    version of the kernel).  Returns rank-major C block shards
    (p, C_max + 1, b, b); use ``unpack_monoC_result``.  Thin wrapper over
    the compile-once runtime: same-structure calls hit its cache.
    """
    from repro_torch.distributed.runtime import compile_spgemm, torch_dtype
    from repro_torch.sparse.bsr import to_bsr

    ab = to_bsr(np.asarray(a_dense), block, block)
    bb = to_bsr(np.asarray(b_dense), block, block)
    if len(plan.a_part) != ab.n_blocks or len(plan.b_part) != bb.n_blocks:
        raise ValueError("plan was built for a different block structure")
    exe = compile_spgemm(
        plan,
        ab.block_structure(),
        bb.block_structure(),
        device=device,
        dtype=torch_dtype(np.promote_types(ab.blocks.dtype, bb.blocks.dtype)),
        block=block,
    )
    return exe(ab.blocks, bb.blocks)


def make_monoC_unpack(plan: MonoCPlan, c_structure, shape: tuple[int, int], device):
    """``unpack(c_local) -> dense (shape)`` with its scatter indices
    uploaded once: C block slots go to their block-grid coordinates."""
    local_c = plan.local_ids["c_nz"]
    dev, slot = np.nonzero(local_c >= 0)
    gids = local_c[dev, slot]
    crow, ccol = c_structure.coo()
    device = torch.device(device)
    src = torch.as_tensor(dev * plan.n_c_slots + slot, device=device)
    rows = torch.as_tensor(crow[gids], device=device)
    cols = torch.as_tensor(ccol[gids], device=device)

    def unpack(c_local: torch.Tensor) -> torch.Tensor:
        b = c_local.shape[-1]
        out = c_local.new_zeros((shape[0] // b, shape[1] // b, b, b))
        out[rows, cols] = c_local.reshape(-1, b, b)[src]
        return out.permute(0, 2, 1, 3).reshape(shape)

    return unpack


def unpack_monoC_result(
    c_local: torch.Tensor,
    plan: MonoCPlan,
    c_structure,
    shape: tuple[int, int],
) -> torch.Tensor:
    """Scatter rank-major C block slots back to a dense tensor on
    ``c_local``'s device.  ``c_structure`` is the block-grid structure of C
    (``inst.c`` of the plan instance); ``shape`` the padded dense shape
    (block-grid * block)."""
    return make_monoC_unpack(plan, c_structure, shape, c_local.device)(c_local)
