"""The PyTorch port stands alone: importing and running it — the front door,
the kernel entry point, a session with a plan store and the serving loop —
loads neither jax nor any module of the JAX package ``repro``."""
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
import repro_torch.distributed.select, repro_torch.distributed.spgemm_exec
import repro_torch.kernels.bsr_spgemm, repro_torch.kernels.ref
import repro_torch.kernels.bsr_spmm, repro_torch.kernels.moe_gemm
import repro_torch.kernels.ops, repro_torch.kernels._build
import repro_torch.resilience, repro_torch.testing.faults, repro_torch.checkpoint.store
import repro_torch.distributed.session, repro_torch.launch.serve
from repro_torch.core import matrices
from repro_torch.kernels import ops
from repro_torch.sparse.bsr import to_bsr
from repro_torch.sparse.structure import random_structure

rng = np.random.default_rng(0)
a_s = random_structure(12, 9, 0.3, rng)
b_s = random_structure(9, 10, 0.3, rng)
av = rng.standard_normal(a_s.nnz).astype(np.float32)
bv = rng.standard_normal(b_s.nnz).astype(np.float32)
a = np.zeros(a_s.shape, np.float32); a[a_s.coo()] = av
b = np.zeros(b_s.shape, np.float32); b[b_s.coo()] = bv
for model in ("monoC", "rowwise", "fine"):
    c = repro_torch.plan(a_s, b_s, p=2, model=model).compile(device="cpu")(av, bv)
    np.testing.assert_allclose(c.numpy(), a @ b, rtol=1e-5, atol=1e-5)
a8 = np.kron(rng.random((3, 2)) < 0.7, np.ones((8, 8))).astype(np.float32)
b8 = rng.standard_normal((16, 8)).astype(np.float32)
np.testing.assert_allclose(ops.spmm(to_bsr(a8, 8, 8), b8, device="cpu").numpy(), a8 @ b8,
                           rtol=1e-5, atol=1e-5)
ops.spgemm(to_bsr(a8, 8, 8), to_bsr(b8, 8, 8), device="cpu")
x = rng.standard_normal((2, 8, 16)).astype(np.float32)
np.testing.assert_allclose(ops.grouped_gemm(x, x.transpose(0, 2, 1), device="cpu").numpy(),
                           x @ x.transpose(0, 2, 1), rtol=1e-5, atol=1e-5)
import tempfile
from repro_torch.launch.serve import serve_spgemm
with tempfile.TemporaryDirectory() as store:
    sess = repro_torch.session(p=2, model="monoC", device="cpu", store_dir=store)
    np.testing.assert_allclose(sess.multiply(a, b).numpy(), a @ b, rtol=1e-5, atol=1e-5)
    assert [e.kind for e in sess.events] == ["cold_replan", "saved"], sess.events
requests, report = serve_spgemm([(a, b)] * 3, p=2, model="monoC", device="cpu")
assert report["completed"] == 3 and report["dispatches"] == 1, report
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
