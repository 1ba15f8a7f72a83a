#!/usr/bin/env python3
"""Time the port's BSR x dense SpMM (K2) at several block shapes on one card.

The operator is the AMG n=42 27-point matrix that ``chip_smoke.py`` drives,
with seeded values, tiled by scipy at 12 x 12 (fp32 and bf16), 3 x 3 (fp32)
and 8 x 8 (fp32 and bf16), times a seeded (74,088, 256) dense block.  Each
shape's kernel is held to the plain version on the same inputs and timed
by CUDA-graph replay (``chip_smoke.graph_ms``); one JSON line a shape gives
the route, the time and the rate of the dense slabs it gathers.

Run from the repository root on a machine with a CUDA card:

    python3 tools/time_k2_shapes.py --src src

``--src`` may name the ``src`` directory of another checkout (an unpacked
``git archive``): its ``repro_torch`` is imported and its kernels are built
there, so two trees can be timed at the same shapes on the same card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((12, "float32"), (12, "bfloat16"), (3, "float32"), (8, "float32"), (8, "bfloat16"))
N_COLS = 256


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--src", required=True, help="the src directory whose repro_torch to time")
    src = Path(parser.parse_args().src).resolve()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(src))
    import scipy.sparse as sp
    import torch

    import chip_smoke
    from repro_torch.core.matrices import amg_instances
    from repro_torch.kernels.bsr_spmm import bsr_spmm_local, route, row_offsets
    from repro_torch.kernels.ref import bsr_spmm_ref

    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device: this script runs only on the card")
    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    a_struct = amg_instances(chip_smoke.AMG_N)[0].a
    rng = np.random.default_rng(0)
    vals = rng.standard_normal(a_struct.nnz)
    dense = rng.standard_normal((a_struct.shape[1], N_COLS)).astype(np.float32)
    a = sp.csr_matrix((vals, a_struct.indices, a_struct.indptr), shape=a_struct.shape)
    for block, dtype_name in SHAPES:
        dtype = getattr(torch, dtype_name)
        a_bsr = a.astype(np.float32).tobsr(blocksize=(block, block))
        a_bsr.sort_indices()
        m_blocks = a_struct.shape[0] // block
        brows = np.repeat(np.arange(m_blocks), np.diff(a_bsr.indptr))
        blocks = torch.from_numpy(a_bsr.data).to(device, dtype)
        dense_dev = torch.from_numpy(dense).to(device, dtype)
        row_start = torch.as_tensor(row_offsets(brows, m_blocks), device=device)
        bcols = torch.as_tensor(a_bsr.indices.astype(np.int32), device=device)
        args = (blocks, row_start, bcols, dense_dev, m_blocks)
        got = bsr_spmm_local(*args)
        want = bsr_spmm_ref(blocks, torch.as_tensor(brows, device=device), bcols, dense_dev,
                            m_blocks)
        torch.cuda.synchronize()
        err = chip_smoke.max_err_within(got, want, chip_smoke.TOL[dtype_name],
                                        f"{block}x{block} {dtype_name}")
        ms = chip_smoke.graph_ms(lambda: bsr_spmm_local(*args))
        gathered = len(a_bsr.indices) * block * N_COLS * blocks.element_size()
        print(json.dumps({
            "src": str(src), "block": block, "dtype": dtype_name,
            "kernel": route(block, block, dtype), "n_blocks": len(a_bsr.indices),
            "ms": ms, "max_abs_err": err, "gathered_bytes": gathered,
            "gathered_tb_per_s": gathered / ms / 1e9,
        }), flush=True)
    print(card)


if __name__ == "__main__":
    main()
