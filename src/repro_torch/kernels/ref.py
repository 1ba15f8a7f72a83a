"""Plain PyTorch versions of the port's kernels (the allclose ground truth).

Each mirrors the oracle of the same name in ``repro.kernels.ref``.  The
kernel wrappers run these for tensors that lie on the CPU; on the card the
wrappers launch the hand-written kernels and ``chip_smoke.py`` holds them
against these functions on the same inputs.
"""
from __future__ import annotations

import torch


def _acc_dtype(out_dtype: torch.dtype) -> torch.dtype:
    """fp32, or wider for float64 inputs: the type products are summed in."""
    return torch.promote_types(out_dtype, torch.float32)


def bsr_spmm_ref(
    blocks: torch.Tensor,  # (nb, bm, bk)
    brows: torch.Tensor,  # (nb,)
    bcols: torch.Tensor,  # (nb,)
    dense: torch.Tensor,  # (K, N)
    m_blocks: int,
) -> torch.Tensor:
    """A_bsr @ dense -> (m_blocks * bm, N) in ``promote_types(blocks,
    dense)``.  Block products and their sums per block-row are taken in
    fp32 and cast once, as the kernel does."""
    nb, bm, bk = blocks.shape
    K, N = dense.shape
    out_dtype = torch.promote_types(blocks.dtype, dense.dtype)
    acc_dtype = _acc_dtype(out_dtype)
    tiles = dense.to(acc_dtype).reshape(K // bk, bk, N)
    contrib = torch.einsum("nij,njk->nik", blocks.to(acc_dtype), tiles[bcols])
    out = torch.zeros((m_blocks, bm, N), dtype=acc_dtype, device=blocks.device)
    out.index_add_(0, brows, contrib)
    return out.reshape(m_blocks * bm, N).to(out_dtype)


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
    acc_dtype = _acc_dtype(out_dtype)
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


def moe_gemm_ref(
    x: torch.Tensor,  # (E, C, d)
    w: torch.Tensor,  # (E, d, f)
) -> torch.Tensor:
    """Grouped expert GEMM (the MoE dispatch SpGEMM's dense payload).

    Summed in fp32 and returned in **``x.dtype``**, as the TPU kernel and
    the port's kernel write it.  The JAX package's oracle (an einsum)
    promotes instead, so for a bf16 ``x`` and an fp32 ``w`` it returns fp32
    where both kernels return bf16; this version follows the kernels.
    """
    acc_dtype = _acc_dtype(torch.promote_types(x.dtype, w.dtype))
    return torch.einsum("ecd,edf->ecf", x.to(acc_dtype), w.to(acc_dtype)).to(x.dtype)


def moe_gemm_grad_ref(
    x: torch.Tensor,  # (E, C, d)
    w: torch.Tensor,  # (E, d, f)
    dy: torch.Tensor,  # (E, C, f)
) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradient of ``moe_gemm_ref(x, w)`` at ``dy``: ``dx = dy @ wᵀ``
    in ``x.dtype`` and ``dw = xᵀ @ dy`` in ``w.dtype``, each summed in fp32
    (or wider) and rounded once: ``moe_gemm_ref`` on the transposed
    operands.  The plain version of ``kernels.moe_gemm.moe_gemm_backward``."""
    wide = torch.promote_types(x.dtype, w.dtype)  # the type the one rounding is from
    dx = moe_gemm_ref(dy.to(torch.promote_types(wide, dy.dtype)), w.transpose(1, 2))
    dw = moe_gemm_ref(x.transpose(1, 2).to(wide), dy)
    return dx.to(x.dtype), dw.to(w.dtype)


def split3_bf16_ref(x: torch.Tensor, pitch: int | None = None) -> torch.Tensor:
    """fp32 ``x`` as three bf16 pieces, (3, *x.shape): ``x0 = bf16(x)``,
    ``x1 = bf16(x - x0)``, ``x2 = bf16(x - x0 - x1)``, each rounded to
    nearest.  Every residual is exact in fp32, so ``x0 + x1 + x2 == x``
    exactly for finite x whose last piece does not underflow.  With
    ``pitch``, each row is first padded with zeros to ``pitch`` values
    (zeros split into zeros).  The plain version of ``csrc/moe_gemm.cu``'s
    ``split3_bf16``; the card's main path never calls it."""
    x = x.float()
    if pitch is not None:
        x = torch.nn.functional.pad(x, (0, pitch - x.shape[-1]))
    x0 = x.to(torch.bfloat16)
    r = x - x0.float()
    x1 = r.to(torch.bfloat16)
    x2 = (r - x1.float()).to(torch.bfloat16)
    return torch.stack([x0, x1, x2])


def stage16_ref(x: torch.Tensor, pitch: int) -> torch.Tensor:
    """A contiguous (*x.shape[:-1], pitch) copy of ``x``: each row's first
    min(x.shape[-1], pitch) values, then zeros.  The plain version of
    ``csrc/moe_gemm.cu``'s ``stage16``."""
    cols = x.shape[-1]
    if pitch <= cols:
        return x[..., :pitch].clone(memory_format=torch.contiguous_format)
    return torch.nn.functional.pad(x, (0, pitch - cols))


def split3_bf16_t_ref(x: torch.Tensor, pitch: int) -> torch.Tensor:
    """The three bf16 pieces of ``x.transpose(-1, -2)``, rows padded with
    zeros to ``pitch``: (3, ..., cols, pitch).  The split is elementwise, so
    this is ``split3_bf16_ref`` of the transposed copy.  The plain version
    of ``csrc/moe_gemm.cu``'s ``split3_bf16_t``."""
    return split3_bf16_ref(x.transpose(-1, -2).contiguous(), pitch)
