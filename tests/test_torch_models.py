"""The port's six other paper models (rowwise, columnwise, outer, fine, monoA,
monoB) and ``model="auto"`` on the CPU (loopback ranks): against dense
``A @ B``, against the JAX package's front door on the same seeded values,
and their plans, words and selection records against the JAX package's,
exactly.

JAX sees one CPU device in this process, so its p = 4 runs happen in one
subprocess with four forced host devices (as ``tests/multidev_runner.py``).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import repro
import repro_torch
from repro.core import matrices as jax_matrices
from repro.distributed.runtime import plan_fingerprint as jax_fingerprint
from repro.distributed.select import sweep_instance as jax_sweep
from repro.sparse.structure import from_dense as jax_from_dense
from repro_torch.core import matrices
from repro_torch.distributed import registry
from repro_torch.distributed.comm import Loopback
from repro_torch.distributed.plan_ir import (
    FinePlan,
    OuterPlan,
    RowwisePlan,
    moved_items,
    plan_fine_from_dense,
    plan_from_reference,
)
from repro_torch.distributed.select import sweep_instance
from repro_torch.distributed.spgemm_exec import (
    fine_spgemm,
    outer_product_spgemm,
    rowwise_spgemm,
    unpack_fine_result,
    unpack_rowwise_result,
)
from repro_torch.distributed.runtime import plan_fingerprint
from repro_torch.sparse.structure import from_dense
from test_torch_gpu import stacked_rowwise
from test_torch_planning import _same_plan

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)  # executor vs dense A @ B (multidev_runner)
TOL_JAX = dict(rtol=1e-5, atol=1e-5)  # port vs reference: summation order only
NEW_MODELS = ("rowwise", "columnwise", "outer", "fine", "monoA", "monoB")
PLAN_CLASS = {"rowwise": RowwisePlan, "columnwise": RowwisePlan, "outer": OuterPlan,
              "fine": FinePlan, "monoA": FinePlan, "monoB": FinePlan}


def _operands(name: str):
    """Seeded dense operands: rectangular random, or AMG 27-AP at n=6 with
    random values on its structure."""
    rng = np.random.default_rng(21)
    if name == "random":
        a = rng.standard_normal((34, 27)) * (rng.random((34, 27)) < 0.15)
        b = rng.standard_normal((27, 31)) * (rng.random((27, 31)) < 0.18)
        return a.astype(np.float32), b.astype(np.float32)
    inst = matrices.amg_instances(6)[0]
    dense = []
    for s in (inst.a, inst.b):
        x = np.zeros(s.shape, np.float32)
        x[s.coo()] = rng.standard_normal(s.nnz)
        dense.append(x)
    return tuple(dense)


def _values(a, b, a_s, b_s):
    return a[a_s.coo()], b[b_s.coo()]


def _port(a, b, p, model):
    """The port's front door on the CPU: (handle, compiled, dense C)."""
    a_s, b_s = from_dense(a), from_dense(b)
    handle = repro_torch.plan(a_s, b_s, p=p, model=model)
    exe = handle.compile(device="cpu")
    return handle, exe, exe(*_values(a, b, a_s, b_s))


@pytest.mark.parametrize("p", [1, 2, 4, 8])
@pytest.mark.parametrize("model", NEW_MODELS)
def test_every_model_matches_dense_and_moves_the_planned_items(model, p):
    for name in ("random", "amg"):
        a, b = _operands(name)
        handle, exe, c = _port(a, b, p, model)
        assert c.device.type == "cpu" and tuple(c.shape) == (a.shape[0], b.shape[1])
        np.testing.assert_allclose(c.numpy(), a @ b, **TOL)
        assert isinstance(handle.execution_plan, PLAN_CLASS[model])
        report = handle.cost_report()
        assert report["planned_words"] == report["predicted_words"], (name, report)
        comm = exe.runtime.comm
        comm.reset()
        exe(*_values(a, b, handle.instance.a, handle.instance.b))
        plan = handle.execution_plan
        assert comm.items_moved == moved_items(plan), name
        if model == "outer":  # the fold moves dense padded C row blocks
            assert comm.items_moved == plan.stats["fold_words_padded"]
        else:
            assert comm.items_moved == report.get("planned_items", report["planned_words"])


@pytest.mark.parametrize("p", [1, 4])
@pytest.mark.parametrize("model", NEW_MODELS)
def test_plans_reports_and_fingerprints_equal_jax(model, p):
    for name in ("random", "amg"):
        a, b = _operands(name)
        hj = repro.plan(jax_from_dense(a), jax_from_dense(b), p=p, model=model)
        ht = repro_torch.plan(from_dense(a), from_dense(b), p=p, model=model)
        np.testing.assert_array_equal(hj.partition.parts, ht.partition.parts)
        _same_plan(hj.execution_plan, ht.execution_plan)
        assert hj.cost_report() == ht.cost_report(), name
        assert jax_fingerprint(hj.execution_plan) == plan_fingerprint(ht.execution_plan)


@pytest.mark.parametrize("model", NEW_MODELS)
def test_matches_jax_at_p1_in_process(model):
    for name in ("random", "amg"):
        a, b = _operands(name)
        a_s, b_s = from_dense(a), from_dense(b)
        want = np.asarray(repro.plan(a, b, p=1, model=model).compile()(*_values(a, b, a_s, b_s)))
        _, _, got = _port(a, b, 1, model)
        np.testing.assert_allclose(got.numpy(), want, **TOL_JAX)


_JAX_P4 = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, repro
from repro.sparse.structure import from_dense
d = np.load(sys.argv[1])
out = {}
for name in ("random", "amg"):
    a, b = d[name + "_a"], d[name + "_b"]
    a_s, b_s = from_dense(a), from_dense(b)
    for model in sys.argv[3].split(","):
        exe = repro.plan(a_s, b_s, p=4, model=model).compile()
        out[f"{name}/{model}"] = np.asarray(exe(a[a_s.coo()], b[b_s.coo()]))
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def jax_p4(tmp_path_factory):
    """The JAX package's p = 4 front-door results on this module's operands."""
    tmp = tmp_path_factory.mktemp("jax_p4_models")
    ops = {}
    for name in ("random", "amg"):
        ops[name + "_a"], ops[name + "_b"] = _operands(name)
    np.savez(tmp / "in.npz", **ops)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, "-c", _JAX_P4, str(tmp / "in.npz"), str(tmp / "out.npz"),
         ",".join(NEW_MODELS)],
        capture_output=True, text=True, env=env, timeout=600,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    return np.load(tmp / "out.npz")


@pytest.mark.parametrize("model", NEW_MODELS)
def test_matches_jax_at_p4(jax_p4, model):
    for name in ("random", "amg"):
        a, b = _operands(name)
        _, _, got = _port(a, b, 4, model)
        np.testing.assert_allclose(got.numpy(), jax_p4[f"{name}/{model}"], **TOL_JAX)


@pytest.mark.parametrize("model", NEW_MODELS)
def test_jax_plan_through_plan_from_reference(jax_p4, model):
    # the JAX package lowers the plan, the port executes it
    for name in ("random", "amg"):
        a, b = _operands(name)
        a_s, b_s = from_dense(a), from_dense(b)
        jax_handle = repro.plan(a, b, p=4, model=model)
        handle = repro_torch.plan(a_s, b_s, p=4, model=model)
        carried = plan_from_reference(jax_handle.execution_plan)
        assert type(carried) is PLAN_CLASS[model]
        _same_plan(jax_handle.execution_plan, carried)
        handle.execution_plan = carried
        got = handle.compile(device="cpu")(*_values(a, b, a_s, b_s))
        np.testing.assert_allclose(got.numpy(), jax_p4[f"{name}/{model}"], **TOL_JAX)


def _auto_instances():
    """(JAX instance, port instance) as ``benchmarks/bench_versus.py``
    plans them at its quick scale."""
    return [
        (jax_matrices.amg_instances(6)[0], matrices.amg_instances(6)[0], "rowwise"),
        (jax_matrices.lp_instance("fome21", scale=0.02),
         matrices.lp_instance("fome21", scale=0.02), "outer"),
    ]


def test_auto_selects_as_jax():
    for ji, ti, expected in _auto_instances():
        hj = repro.plan(ji, p=4, model="auto")
        ht = repro_torch.plan(ti, p=4, model="auto")
        assert ht.model == hj.model == expected
        assert ht.selection == hj.selection
        assert [r["model"] for r in ht.selection] == list(repro_torch.executable_models())
        assert sum(r["selected"] for r in ht.selection) == 1
        best = min(ht.selection, key=lambda r: r["predicted_words"])
        assert best["selected"] and best["model"] == ht.model
        _same_plan(hj.execution_plan, ht.execution_plan)


def test_auto_runs_and_matches_dense():
    for p in (1, 2, 4, 8):
        a, b = _operands("random")
        handle, _, c = _port(a, b, p, "auto")
        assert handle.model in repro_torch.executable_models()
        assert [r["selected"] for r in handle.selection].count(True) == 1
        np.testing.assert_allclose(c.numpy(), a @ b, **TOL)


@pytest.mark.parametrize("p", [2, 4])
def test_sweep_equals_jax_and_executes(p):
    ji, ti = jax_matrices.amg_instances(6)[0], matrices.amg_instances(6)[0]
    timing = {"us_per_call", "exec_s", "exec_warm_us", "exec_max_err"}
    want = [{k: v for k, v in r.items() if k not in timing} for r in jax_sweep(ji, p)]
    a, b = _operands("amg")
    got = sweep_instance(ti, p, a_dense=a, b_dense=b, execute=True, device="cpu")
    for rec in got:
        assert rec["exec_max_err"] < 1e-4, rec
    assert [{k: v for k, v in r.items() if k not in timing} for r in got] == want


@pytest.mark.parametrize("p", [2, 4])
def test_include_nz_fine_plan_lowers_and_runs(p):
    a, b = _operands("random")
    a_s, b_s = from_dense(a), from_dense(b)
    hj = repro.plan(jax_from_dense(a), jax_from_dense(b), p=p, model="fine", include_nz=True)
    ht = repro_torch.plan(a_s, b_s, p=p, model="fine", include_nz=True)
    assert ht.execution_plan is not None
    _same_plan(hj.execution_plan, ht.execution_plan)
    assert hj.cost_report() == ht.cost_report()
    c = ht.compile(device="cpu")(*_values(a, b, a_s, b_s))
    np.testing.assert_allclose(c.numpy(), a @ b, **TOL)
    # the other models' lowerers take no V^nz partition: cost-only handles
    rowwise = repro_torch.plan(a_s, b_s, p=p, model="rowwise", include_nz=True)
    assert rowwise.execution_plan is None
    with pytest.raises(ValueError, match="include_nz"):
        rowwise.compile(device="cpu")


def test_dense_and_sparse_entry_points():
    a, b = _operands("random")
    a_s, b_s = from_dense(a), from_dense(b)
    plan, inst = plan_fine_from_dense(sp.csr_matrix(a), b_s, 4)
    # scipy and (structure, values) operands, never densified
    c_local = fine_spgemm(sp.csr_matrix(a), (b_s, b[b_s.coo()]), plan, device="cpu")
    c = unpack_fine_result(c_local, plan, inst.c, (a.shape[0], b.shape[1]))
    np.testing.assert_allclose(c.numpy(), a @ b, **TOL)
    with pytest.raises(ValueError, match="different nonzero structure"):
        fine_spgemm(a[:, :-1], b[:-1], plan, device="cpu")
    rw = repro_torch.plan(a_s, b_s, p=4, model="rowwise").execution_plan
    c = unpack_rowwise_result(rowwise_spgemm(a, b, rw, device="cpu"), rw, a.shape[0])
    np.testing.assert_allclose(c.numpy(), a @ b, **TOL)
    op = repro_torch.plan(a_s, b_s, p=4, model="outer").execution_plan
    c = outer_product_spgemm(a, b, op, device="cpu").reshape(-1, b.shape[1])[: a.shape[0]]
    np.testing.assert_allclose(c.numpy(), a @ b, **TOL)


def test_transpose_gives_the_csr_order_columnwise_permutes_into():
    a, _ = _operands("amg")
    ts, js = from_dense(a).transpose(), jax_from_dense(a).transpose()
    np.testing.assert_array_equal(ts.indptr, js.indptr)
    np.testing.assert_array_equal(ts.indices, js.indices)
    # CSR order of X^T enumerates X's nonzeros sorted by (col, row)
    r, c = from_dense(a).coo()
    order = np.lexsort((r, c))
    tr, tc = ts.coo()
    np.testing.assert_array_equal(tr, c[order])
    np.testing.assert_array_equal(tc, r[order])


@pytest.mark.parametrize("p", [1, 3, 4])
def test_rank_by_rank_rowwise_equals_stacked_tables(p):
    # columnwise's executor is rowwise on the transposed operands: its
    # tables, built one rank at a time, against all p stacked at once
    a, b = _operands("random")
    handle, exe, _ = _port(a, b, p, "columnwise")
    a_local, b_local = exe.runtime.pack(*exe.pack(*_values(a, b, handle.instance.a,
                                                         handle.instance.b)))
    got = exe.runtime.step(a_local, b_local)
    want = stacked_rowwise(handle.execution_plan, a_local, b_local, a.shape[1], a.shape[0])
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL_JAX)


def test_loopback_psum_scatter():
    comm = Loopback(3)
    buf = torch.arange(3 * 3 * 2 * 4, dtype=torch.float32).reshape(3, 3, 2, 4)
    out = comm.psum_scatter(buf)
    np.testing.assert_array_equal(out.numpy(), buf.numpy().sum(0))
    assert comm.items_moved == 2 * 3 * 2 * 4  # (p - 1) / p of the stack
    with pytest.raises(ValueError, match="buffer"):
        comm.psum_scatter(buf[:2])


def test_registry_fields_equal_jax():
    from repro.distributed import registry as jax_registry

    assert registry.executable_models() == jax_registry.executable_models()
    assert repro_torch.executable_models() == repro.executable_models()
    ji = jax_matrices.amg_instances(6)[0]
    ti = matrices.amg_instances(6)[0]
    for name, spec in registry.MODEL_SPECS.items():
        ref = jax_registry.MODEL_SPECS[name]
        for field in ("family", "needs_c_structure", "lower_include_nz", "measured", "in_auto"):
            assert getattr(spec, field) == getattr(ref, field), (name, field)
        want, got = ref.item_words(ji), spec.item_words(ti)
        assert (want is None) == (got is None), name
        for route in want or {}:
            np.testing.assert_array_equal(want[route], got[route])


@pytest.mark.parametrize("model", NEW_MODELS + ("auto",))
def test_compile_defaults_to_the_card(model):
    a, b = _operands("random")
    a_s, b_s = from_dense(a), from_dense(b)
    handle = repro_torch.plan(a_s, b_s, p=2, model=model)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card error cannot show")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        handle.compile()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        handle(*_values(a, b, a_s, b_s))
