"""Plain PyTorch versions of the port's kernels (the allclose ground truth).

Each mirrors the oracle of the same name in ``repro.kernels.ref``.  The
kernel wrappers run these for tensors that lie on the CPU; on the card the
wrappers launch the hand-written kernels and ``chip_smoke.py`` holds them
against these functions on the same inputs.
"""
from __future__ import annotations

import torch


def bsr_spgemm_ref(
    a_blocks: torch.Tensor,  # (na, bm, bk)
    b_blocks: torch.Tensor,  # (nbb, bk, bn)
    pair_a: torch.Tensor,  # (np,) index into a_blocks
    pair_b: torch.Tensor,  # (np,) index into b_blocks
    pair_c: torch.Tensor,  # (np,) index into C block list
    n_c_blocks: int,
) -> torch.Tensor:
    """Block-sparse x block-sparse -> C blocks (nc, bm, bn).

    The (pair_a, pair_b, pair_c) lists are the inspector output: every
    nontrivial block multiplication and the C block it accumulates into —
    exactly the coarsened multiplication vertices v_(IKJ) of the tiled
    SpGEMM hypergraph.  Products and their sums are taken in fp32 (or wider,
    for float64 inputs) and cast once to ``promote_types(a, b)``, as the
    kernel does.
    """
    out_dtype = torch.promote_types(a_blocks.dtype, b_blocks.dtype)
    acc_dtype = torch.promote_types(out_dtype, torch.float32)
    prod = torch.einsum(
        "nij,njk->nik",
        a_blocks[pair_a].to(acc_dtype),
        b_blocks[pair_b].to(acc_dtype),
    )
    out = torch.zeros(
        (n_c_blocks, a_blocks.shape[1], b_blocks.shape[2]),
        dtype=acc_dtype,
        device=a_blocks.device,
    )
    return out.index_add_(0, pair_c, prod).to(out_dtype)
