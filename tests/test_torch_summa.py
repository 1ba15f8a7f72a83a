"""The port's Sparse SUMMA baseline (``repro_torch.distributed.summa``,
``model="summa2d"``) and the dense ``spsumma`` on the CPU (loopback ranks),
held to the JAX package on the same seeded inputs: plans identical array for
array on every factorization of p, the words the collective moves equal to
the closed form ``nnz(A)(pc - 1) + nnz(B)(pr - 1)``, the grid choice, the
cost report, the front door against dense ``A @ B`` and against
``repro.plan(..., model="summa2d")``, store entries read by either package,
and ``spsumma`` against JAX's.

JAX sees one CPU device in this process, so its p = 4 runs happen in one
subprocess with four forced host devices (as ``tests/multidev_runner.py``).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import repro
import repro_torch
from repro.checkpoint import restore_plan as jax_restore_plan
from repro.checkpoint import save_plan as jax_save_plan
from repro.core.spgemm_models import SpGEMMInstance as JaxInstance
from repro.distributed import summa as jax_summa
from repro.distributed.runtime import plan_fingerprint as jax_fingerprint
from repro.distributed.spgemm_exec import spsumma as jax_spsumma
from repro.sparse.structure import from_dense as jax_from_dense
from repro_torch.api import PlannedSpGEMM
from repro_torch.checkpoint import restore_plan, save_plan
from repro_torch.core.spgemm_models import SpGEMMInstance
from repro_torch.distributed import build_summa_plan, spsumma, summa_words_ideal
from repro_torch.distributed.comm import Loopback
from repro_torch.distributed.plan_ir import measured_route_words, moved_items
from repro_torch.distributed.runtime import plan_fingerprint
from repro_torch.distributed.summa import SummaPlan, summa_mesh_shape
from repro_torch.sparse.structure import from_dense
from test_torch_planning import _same_plan

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)  # against dense A @ B and against the reference
P_VALUES = (1, 2, 3, 4, 6, 8)


def _operands(name: str):
    """Seeded dense float32 operands: rectangular random, or AMG 27-AP at
    n=6 with random values on its structure."""
    rng = np.random.default_rng(19)
    if name == "random":
        a = rng.standard_normal((34, 27)) * (rng.random((34, 27)) < 0.15)
        b = rng.standard_normal((27, 31)) * (rng.random((27, 31)) < 0.18)
        return a.astype(np.float32), b.astype(np.float32)
    from repro_torch.core import matrices

    inst = matrices.amg_instances(6)[0]
    dense = []
    for s in (inst.a, inst.b):
        x = np.zeros(s.shape, np.float32)
        x[s.coo()] = rng.standard_normal(s.nnz)
        dense.append(x)
    return tuple(dense)


def _instances(a, b):
    return (JaxInstance(jax_from_dense(a), jax_from_dense(b)),
            SpGEMMInstance(from_dense(a), from_dense(b)))


def _factorizations(p: int):
    return [(pr, p // pr) for pr in range(1, p + 1) if p % pr == 0]


def _values(a, b, inst):
    return a[inst.a.coo()], b[inst.b.coo()]


# ---------------------------------------------------------------------------
# planning: the copy equals the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("p", P_VALUES)
def test_plan_identical_to_jax_for_every_factorization(p):
    for name in ("random", "amg"):
        ji, ti = _instances(*_operands(name))
        for pr, pc in _factorizations(p):
            jp = jax_summa.build_summa_plan(ji, p, pr=pr, pc=pc)
            tp = build_summa_plan(ti, p, pr=pr, pc=pc)
            assert isinstance(tp, SummaPlan)
            _same_plan(jp, tp)
            assert (tp.pr, tp.pc, tp.n_stages, tp.n_c_slots) == (
                jp.pr, jp.pc, jp.n_stages, jp.n_c_slots)
            assert plan_fingerprint(tp) == jax_fingerprint(jp)


@pytest.mark.parametrize("p", P_VALUES)
def test_measured_words_equal_closed_form(p):
    """The routes, and the items one call of the executor hands its
    collective, are exactly ``nnz(A)(pc - 1) + nnz(B)(pr - 1)`` on every
    factorization; the product equals dense ``A @ B``."""
    a, b = _operands("random")
    _, ti = _instances(a, b)
    for pr, pc in _factorizations(p):
        plan = build_summa_plan(ti, p, pr=pr, pc=pc)
        want = summa_words_ideal(ti, pr, pc)
        assert want == ti.a.nnz * (pc - 1) + ti.b.nnz * (pr - 1)
        assert measured_route_words(plan) == plan.comm_words_ideal == want
        assert moved_items(plan) == want
        handle = PlannedSpGEMM(
            instance=ti, model="summa2d", hypergraph=None, partition=None,
            execution_plan=plan)
        exe = handle.compile(device="cpu")
        exe.runtime.comm.reset()
        c = exe(*_values(a, b, ti))
        assert exe.runtime.comm.items_moved == want, (pr, pc)
        np.testing.assert_allclose(c.numpy(), a @ b, **TOL)


def test_mesh_shape_equal_to_jax():
    for name in ("random", "amg"):
        ji, ti = _instances(*_operands(name))
        for p in range(1, 13):
            assert summa_mesh_shape(p) == jax_summa.summa_mesh_shape(p)
            assert summa_mesh_shape(p, ti) == jax_summa.summa_mesh_shape(p, ji)
        # the front door lowers on the grid summa_mesh_shape picks
        plan = repro_torch.plan(ti, p=6, model="summa2d").execution_plan
        assert (plan.pr, plan.pc) == summa_mesh_shape(6, ti)


# ---------------------------------------------------------------------------
# the front door
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("p", P_VALUES)
def test_front_door_matches_dense_and_reports_as_jax(p):
    for name in ("random", "amg"):
        a, b = _operands(name)
        ji, ti = _instances(a, b)
        handle = repro_torch.plan(ti, p=p, model="summa2d")
        ref = repro.plan(ji, p=p, model="summa2d")
        assert handle.partition is None and handle.hypergraph is None and handle.p == p
        _same_plan(ref.execution_plan, handle.execution_plan)
        report = handle.cost_report()
        assert report == ref.cost_report()
        assert report["predicted_words"] == report["planned_words"]
        exe = handle.compile(device="cpu")
        c = exe(*_values(a, b, ti))
        assert c.device.type == "cpu" and tuple(c.shape) == (a.shape[0], b.shape[1])
        np.testing.assert_allclose(c.numpy(), a @ b, **TOL)


def test_batched_summa_equals_looped():
    """``compile(batch=n)`` (the reference lifts summa2d's step by vmap): one
    K1 pass a stage over every value set, each set bit for bit its
    unbatched result, the collective counting every set."""
    a, b = _operands("amg")
    _, ti = _instances(a, b)
    handle = repro_torch.plan(ti, p=4, model="summa2d")
    av, bv = _values(a, b, ti)
    stacks = (np.stack([av, -2 * av, 0.5 * av]), np.stack([bv, bv, 3 * bv]))
    exe = handle.compile(device="cpu", batch=3)
    exe.runtime.comm.reset()
    got = exe(*stacks)
    assert exe.runtime.comm.items_moved == exe.batch_capacity * moved_items(
        handle.execution_plan)
    one = handle.compile(device="cpu")
    for i in range(3):
        assert np.array_equal(got[i].numpy(), one(stacks[0][i], stacks[1][i]).numpy())


def test_auto_never_picks_summa2d():
    a, b = _operands("random")
    _, ti = _instances(a, b)
    assert "summa2d" not in repro_torch.executable_models()
    handle = repro_torch.plan(ti, p=4, model="auto")
    assert handle.model != "summa2d"
    assert "summa2d" not in [r["model"] for r in handle.selection]
    with pytest.raises(ValueError, match="partition-free"):
        repro_torch.plan(ti, p=4, model="summa2d").costs()


def test_matches_jax_at_p1_in_process():
    for name in ("random", "amg"):
        a, b = _operands(name)
        ji, ti = _instances(a, b)
        want = np.asarray(repro.plan(ji, p=1, model="summa2d").compile()(*_values(a, b, ti)))
        got = repro_torch.plan(ti, p=1, model="summa2d").compile(device="cpu")(
            *_values(a, b, ti))
        np.testing.assert_allclose(got.numpy(), want, **TOL)


_JAX_P4 = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np, repro
from jax.sharding import Mesh
from repro.distributed.spgemm_exec import spsumma
from repro.sparse.structure import from_dense
d = np.load(sys.argv[1])
out = {}
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("x", "y"))
for name in ("random", "amg"):
    a, b = d[name + "_a"], d[name + "_b"]
    a_s, b_s = from_dense(a), from_dense(b)
    exe = repro.plan(a_s, b_s, p=4, model="summa2d").compile()
    out[name + "/summa2d"] = np.asarray(exe(a[a_s.coo()], b[b_s.coo()]))
    out[name + "/spsumma"] = np.asarray(spsumma(a, b, mesh))
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def jax_p4(tmp_path_factory):
    """The JAX package's p = 4 summa2d and 2 x 2 spsumma results."""
    tmp = tmp_path_factory.mktemp("jax_p4_summa")
    ops = {}
    for name in ("random", "amg"):
        ops[name + "_a"], ops[name + "_b"] = _operands(name)
    np.savez(tmp / "in.npz", **ops)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, "-c", _JAX_P4, str(tmp / "in.npz"), str(tmp / "out.npz")],
        capture_output=True, text=True, env=env, timeout=600,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    return np.load(tmp / "out.npz")


@pytest.mark.parametrize("name", ["random", "amg"])
def test_matches_jax_at_p4(jax_p4, name):
    a, b = _operands(name)
    _, ti = _instances(a, b)
    got = repro_torch.plan(ti, p=4, model="summa2d").compile(device="cpu")(*_values(a, b, ti))
    np.testing.assert_allclose(got.numpy(), jax_p4[f"{name}/summa2d"], **TOL)


# ---------------------------------------------------------------------------
# the plan store, both ways
# ---------------------------------------------------------------------------
def test_jax_summa_entry_restores_and_executes_in_the_port(tmp_path):
    a, b = _operands("amg")
    ji, ti = _instances(a, b)
    ref = repro.plan(ji, p=4, model="summa2d").execution_plan
    store = str(tmp_path / "store")
    jax_save_plan(store, "summa", ref, meta={"p": 4})
    back = restore_plan(store, "summa")
    assert type(back.plan) is SummaPlan
    _same_plan(ref, back.plan)
    assert plan_fingerprint(back.plan) == jax_fingerprint(ref)
    handle = repro_torch.plan(ti, p=4, model="summa2d")
    handle.execution_plan = back.plan
    c = handle.compile(device="cpu")(*_values(a, b, ti))
    np.testing.assert_allclose(c.numpy(), a @ b, **TOL)


def test_port_summa_entry_restores_and_executes_in_jax(tmp_path):
    # JAX executes its summa2d plans on p devices; this process has one
    a, b = _operands("random")
    ji, ti = _instances(a, b)
    plan = repro_torch.plan(ti, p=1, model="summa2d").execution_plan
    store = str(tmp_path / "store")
    save_plan(store, "summa", plan)
    back = jax_restore_plan(store, "summa")
    assert type(back.plan).__name__ == "SummaPlan"
    _same_plan(back.plan, plan)
    assert jax_fingerprint(back.plan) == plan_fingerprint(plan)
    handle = repro.plan(ji, p=1, model="summa2d")
    handle.execution_plan = back.plan
    c = np.asarray(handle.compile()(*_values(a, b, ti)))
    np.testing.assert_allclose(c, a @ b, **TOL)


# ---------------------------------------------------------------------------
# spsumma: the dense stationary-C baseline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("grid", [(1, 1), (2, 2), (2, 3), (3, 2), (1, 4)])
def test_spsumma_matches_dense_and_counts_the_gathers(grid):
    rng = np.random.default_rng(2)
    a = (rng.standard_normal((19, 22)) * (rng.random((19, 22)) < 0.3)).astype(np.float32)
    b = (rng.standard_normal((22, 17)) * (rng.random((22, 17)) < 0.3)).astype(np.float32)
    pr, pc = grid
    comm = Loopback(pr * pc)
    c = spsumma(a, b, grid, device="cpu", comm=comm)
    assert c.device.type == "cpu" and tuple(c.shape) == (19, 17)
    np.testing.assert_allclose(c.numpy(), a @ b, **TOL)
    # every rank receives the other pc - 1 A blocks of its grid row and the
    # other pr - 1 B blocks of its grid column, padded blocks whole
    p = pr * pc
    I_p, K_p, J_p = -(-19 // pr) * pr, -(-22 // p) * p, -(-17 // pc) * pc
    assert comm.items_moved == I_p * K_p * (pc - 1) + K_p * J_p * (pr - 1)


def test_spsumma_matches_jax(jax_p4):
    for name in ("random", "amg"):
        a, b = _operands(name)
        c = spsumma(a, b, (2, 2), device="cpu")
        np.testing.assert_allclose(c.numpy(), jax_p4[f"{name}/spsumma"], **TOL)
    # in process, on a 1 x 1 mesh of this process' one device
    import jax
    from jax.sharding import Mesh

    a, b = _operands("random")
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("x", "y"))
    np.testing.assert_allclose(spsumma(a, b, (1, 1), device="cpu").numpy(),
                               np.asarray(jax_spsumma(a, b, mesh)), **TOL)
