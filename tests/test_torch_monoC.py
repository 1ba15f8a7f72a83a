"""The port's monoC pipeline on the CPU (loopback ranks, plain kernel
version): front door at block 1 and the tiled path at block 8, against
dense ``A @ B`` and against the JAX package's executors on the same inputs.

JAX sees one CPU device in this process, so its p = 4 runs happen in one
subprocess with four forced host devices (as ``tests/multidev_runner.py``).
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import repro
import repro_torch
from repro.distributed.plan_ir import plan_monoC_from_dense as jax_plan_from_dense
from repro.distributed.spgemm_exec import monoC_spgemm as jax_monoC_spgemm
from repro.distributed.spgemm_exec import unpack_monoC_result as jax_unpack
from repro_torch.distributed import runtime
from repro_torch.distributed.plan_ir import (
    measured_route_words,
    plan_from_reference,
    plan_monoC_from_dense,
)
from repro_torch.distributed.spgemm_exec import monoC_spgemm, unpack_monoC_result
from repro_torch.sparse.bsr import to_bsr
from repro_torch.sparse.structure import from_dense, spgemm_symbolic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)  # executor vs dense A @ B (multidev_runner)
TOL_JAX = dict(rtol=1e-5, atol=1e-5)  # port vs reference: summation order only
BLOCK = 8


def _random_sparse(rng, m, n, density):
    return (rng.standard_normal((m, n)) * (rng.random((m, n)) < density)).astype(
        np.float32
    )


def _front_operands():
    rng = np.random.default_rng(11)
    return _random_sparse(rng, 34, 27, 0.15), _random_sparse(rng, 27, 31, 0.18)


def _tiled_operands():
    rng = np.random.default_rng(12)
    block_mask = lambda m, n: np.kron(rng.random((m, n)) < 0.3, np.ones((BLOCK, BLOCK)))  # noqa: E731
    a = rng.standard_normal((48, 40)).astype(np.float32) * block_mask(6, 5)
    b = rng.standard_normal((40, 32)).astype(np.float32) * block_mask(5, 4)
    return a.astype(np.float32), b.astype(np.float32)


def _front_door(a, b, p):
    a_s, b_s = from_dense(a), from_dense(b)
    handle = repro_torch.plan(a_s, b_s, p=p, model="monoC")
    exe = handle.compile(device="cpu")
    return handle, exe, exe(a[a_s.coo()], b[b_s.coo()])


def _tiled(a, b, p, plan=None):
    if plan is None:
        plan, _ = plan_monoC_from_dense(a, b, BLOCK, p)
    c_blocks = spgemm_symbolic(
        to_bsr(a, BLOCK, BLOCK).block_structure(),
        to_bsr(b, BLOCK, BLOCK).block_structure(),
    )
    c_local = monoC_spgemm(a, b, plan, device="cpu", block=BLOCK)
    gr, gc = c_blocks.shape
    c = unpack_monoC_result(c_local, plan, c_blocks, (gr * BLOCK, gc * BLOCK))
    return plan, c[: a.shape[0], : b.shape[1]]


@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_front_door_and_tiled_match_dense(p):
    a, b = _front_operands()
    handle, exe, c = _front_door(a, b, p)
    assert c.device.type == "cpu" and c.shape == (34, 31)
    np.testing.assert_allclose(c.numpy(), a @ b, **TOL)
    report = handle.cost_report()
    assert handle.spec.measured == "exact"
    assert report["planned_words"] == report["predicted_words"]
    a, b = _tiled_operands()
    _, c = _tiled(a, b, p)
    np.testing.assert_allclose(c.numpy(), a @ b, **TOL)


def test_matches_jax_at_p1_in_process():
    assert jax.device_count() >= 1
    a, b = _front_operands()
    a_s, b_s = from_dense(a), from_dense(b)
    want = np.asarray(
        repro.plan(a, b, p=1, model="monoC").compile()(a[a_s.coo()], b[b_s.coo()])
    )
    _, _, got = _front_door(a, b, 1)
    np.testing.assert_allclose(got.numpy(), want, **TOL_JAX)

    a, b = _tiled_operands()
    plan, inst = jax_plan_from_dense(a, b, BLOCK, 1)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("x", "y"))
    c_local = jax_monoC_spgemm(a, b, plan, mesh, block=BLOCK)
    gr, gc = inst.c.shape
    want = jax_unpack(c_local, plan, inst.c, (gr * BLOCK, gc * BLOCK))[:48, :32]
    _, got = _tiled(a, b, 1)
    np.testing.assert_allclose(got.numpy(), want, **TOL_JAX)


_JAX_P4 = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np, repro
from jax.sharding import Mesh
from repro.distributed.plan_ir import plan_monoC_from_dense
from repro.distributed.spgemm_exec import monoC_spgemm, unpack_monoC_result
from repro.sparse.structure import from_dense
d = np.load(sys.argv[1])
a, b = d["a"], d["b"]
a_s, b_s = from_dense(a), from_dense(b)
front = repro.plan(a_s, b_s, p=4, model="monoC").compile()(a[a_s.coo()], b[b_s.coo()])
a, b = d["at"], d["bt"]
plan, inst = plan_monoC_from_dense(a, b, 8, 4)
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("x", "y"))
c_local = monoC_spgemm(a, b, plan, mesh, block=8)
gr, gc = inst.c.shape
tiled = unpack_monoC_result(c_local, plan, inst.c, (gr * 8, gc * 8))[:48, :32]
np.savez(sys.argv[2], front=np.asarray(front), tiled=np.asarray(tiled))
"""


@pytest.fixture(scope="module")
def jax_p4(tmp_path_factory):
    """The JAX package's p = 4 results on this module's operands."""
    tmp = tmp_path_factory.mktemp("jax_p4")
    (a, b), (at, bt) = _front_operands(), _tiled_operands()
    np.savez(tmp / "in.npz", a=a, b=b, at=at, bt=bt)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, "-c", _JAX_P4, str(tmp / "in.npz"), str(tmp / "out.npz")],
        capture_output=True, text=True, env=env, timeout=600,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    return np.load(tmp / "out.npz")


def test_matches_jax_at_p4(jax_p4):
    a, b = _front_operands()
    _, _, got = _front_door(a, b, 4)
    np.testing.assert_allclose(got.numpy(), jax_p4["front"], **TOL_JAX)
    a, b = _tiled_operands()
    _, got = _tiled(a, b, 4)
    np.testing.assert_allclose(got.numpy(), jax_p4["tiled"], **TOL_JAX)


def test_jax_plan_through_plan_from_reference(jax_p4):
    # front door: the JAX package lowers the plan, the port executes it
    a, b = _front_operands()
    a_s, b_s = from_dense(a), from_dense(b)
    jax_handle = repro.plan(a, b, p=4, model="monoC")
    handle = repro_torch.plan(a_s, b_s, p=4, model="monoC")
    handle.execution_plan = plan_from_reference(jax_handle.execution_plan)
    got = handle.compile(device="cpu")(a[a_s.coo()], b[b_s.coo()])
    np.testing.assert_allclose(got.numpy(), jax_p4["front"], **TOL_JAX)
    # tiled path
    a, b = _tiled_operands()
    jax_plan, _ = jax_plan_from_dense(a, b, BLOCK, 4)
    _, got = _tiled(a, b, 4, plan=plan_from_reference(jax_plan))
    np.testing.assert_allclose(got.numpy(), jax_p4["tiled"], **TOL_JAX)


@pytest.mark.parametrize("p", [2, 4, 8])
def test_loopback_moves_exactly_the_planned_route_words(p):
    a, b = _front_operands()
    handle, exe, _ = _front_door(a, b, p)
    comm = exe.runtime.comm
    comm.reset()
    a_s, b_s = handle.instance.a, handle.instance.b
    exe(a[a_s.coo()], b[b_s.coo()])
    plan = handle.execution_plan
    assert comm.items_moved == measured_route_words(plan) > 0
    assert measured_route_words(plan) == handle.cost_report()["predicted_words"]

    a, b = _tiled_operands()
    plan, inst = plan_monoC_from_dense(a, b, BLOCK, p)
    exe = runtime.compile_spgemm(plan, inst.a, inst.b, device="cpu", block=BLOCK)
    exe.comm.reset()
    monoC_spgemm(a, b, plan, device="cpu", block=BLOCK)
    assert exe.comm.items_moved * BLOCK * BLOCK == measured_route_words(plan) > 0


def test_runtime_reuses_executors_and_never_writes_inputs():
    a, b = _front_operands()
    handle, exe, first = _front_door(a, b, 4)
    hits = runtime.cache_info()["hits"]
    assert handle.compile(device="cpu").runtime is exe.runtime  # LRU hit
    assert runtime.cache_info()["hits"] == hits + 1
    a_s, b_s = handle.instance.a, handle.instance.b
    av, bv = a[a_s.coo()], b[b_s.coo()]
    av_copy, bv_copy = av.copy(), bv.copy()
    for _ in range(2):
        np.testing.assert_array_equal(exe(av, bv).numpy(), first.numpy())
    np.testing.assert_array_equal(av, av_copy)
    np.testing.assert_array_equal(bv, bv_copy)
    # tensors in, float64 values cast to the handle's dtype
    got = exe(torch.from_numpy(av.astype(np.float64)), torch.from_numpy(bv))
    assert got.dtype == torch.float32
    with pytest.raises(ValueError, match="same-structure"):
        exe(av[:-1], bv)


def test_entry_points_default_to_the_card():
    a, b = _front_operands()
    a_s, b_s = from_dense(a), from_dense(b)
    handle = repro_torch.plan(a_s, b_s, p=2, model="monoC")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card error cannot show")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        handle.compile()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        handle(a[a_s.coo()], b[b_s.coo()])
    a, b = _tiled_operands()
    plan, _ = plan_monoC_from_dense(a, b, BLOCK, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        monoC_spgemm(a, b, plan, block=BLOCK)
