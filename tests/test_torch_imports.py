"""The PyTorch port stands alone: importing and running it loads neither jax
nor any module of the JAX package ``repro``."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CODE = """
import sys
import numpy as np
import repro_torch
import repro_torch.api, repro_torch.core, repro_torch.sparse
import repro_torch.distributed.comm, repro_torch.distributed.plan_ir
import repro_torch.distributed.registry, repro_torch.distributed.runtime
import repro_torch.distributed.spgemm_exec
import repro_torch.kernels.bsr_spgemm, repro_torch.kernels.ref
import repro_torch.kernels._build
from repro_torch.core import matrices
from repro_torch.sparse.structure import random_structure

rng = np.random.default_rng(0)
a_s = random_structure(12, 9, 0.3, rng)
b_s = random_structure(9, 10, 0.3, rng)
av = rng.standard_normal(a_s.nnz).astype(np.float32)
bv = rng.standard_normal(b_s.nnz).astype(np.float32)
c = repro_torch.plan(a_s, b_s, p=2, model="monoC").compile(device="cpu")(av, bv)
a = np.zeros(a_s.shape, np.float32); a[a_s.coo()] = av
b = np.zeros(b_s.shape, np.float32); b[b_s.coo()] = bv
np.testing.assert_allclose(c.numpy(), a @ b, rtol=1e-5, atol=1e-5)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LOADED", bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_and_runs_without_jax_or_repro():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    out = subprocess.run(
        [sys.executable, "-c", _CODE], capture_output=True, text=True, env=env,
        timeout=300,
    )
    assert out.returncode == 0, out.stdout + out.stderr
