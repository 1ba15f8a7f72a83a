"""The PyTorch port stands alone: importing and running it — the front door,
the kernel entry point, a session with a plan store, the serving loop, the
rest of the planning, the LM stack's prefill and decode, the modules of
ranks in their own processes, and training (optimizers, the train step,
step checkpoints, the elastic loop and the launcher), and the sharding
rules, the mesh and the multi-pod dry run (one smoke cell on a fake
group) — loads neither jax nor any module of the JAX package ``repro``;
neither does importing the examples (``examples_torch/``); and no import in
the port, the examples or ``chip_smoke.py`` names a package the machine
with the card lacks."""
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
import repro_torch.distributed.summa, repro_torch.distributed
import repro_torch.core.refine_device, repro_torch.core.coarsen_device, repro_torch._device
import repro_torch.models, repro_torch.configs, repro_torch.data, repro_torch.training
import repro_torch.core.coarsen, repro_torch.core.moe_planner, repro_torch.distributed.plan
import repro_torch.models.convert, repro_torch.configs.shapes
import repro_torch.launch.ranks, repro_torch.training.compression
import repro_torch.training.optimizer, repro_torch.training.step, repro_torch.checkpoint
import repro_torch.launch.elastic, repro_torch.launch.train
import repro_torch.models.sharding, repro_torch.launch.mesh, repro_torch.launch.dryrun
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
for model in ("monoC", "rowwise", "fine", "summa2d"):
    c = repro_torch.plan(a_s, b_s, p=2, model=model).compile(device="cpu")(av, bv)
    np.testing.assert_allclose(c.numpy(), a @ b, rtol=1e-5, atol=1e-5)
np.testing.assert_allclose(repro_torch.distributed.spsumma(a, b, (1, 2), device="cpu").numpy(),
                           a @ b, rtol=1e-5, atol=1e-5)
import importlib
importlib.import_module("repro_torch.core.partition").DEVICE_MIN_VERTICES = 0
for coarsen in ("auto", "host"):
    h = repro_torch.plan(a_s, b_s, p=2, model="fine", engine="device", coarsen=coarsen,
                         device="cpu")
    assert h.partition.phases is not None
    np.testing.assert_allclose(h.compile(device="cpu")(av, bv).numpy(), a @ b,
                               rtol=1e-5, atol=1e-5)
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
import dataclasses
from repro_torch.configs import get_smoke_config
from repro_torch.core.moe_planner import plan_expert_placement, routing_counts
from repro_torch.data import SyntheticTokens
from repro_torch.models import init_params
from repro_torch.training import make_decode_step, make_prefill_step
cfg = get_smoke_config("qwen3-moe-235b-a22b")
gate = rng.integers(0, cfg.moe.n_experts, (256, cfg.moe.top_k))
plan = plan_expert_placement(routing_counts(gate, cfg.moe.n_experts, 8), n_columns=2)
cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
    cfg.moe, expert_placement=tuple(int(e) for e in plan.placement)))
params = init_params(cfg, 0, device="cpu")
tokens = SyntheticTokens(cfg.vocab, 32, 2).batch(0)["tokens"]
logits, cache = make_prefill_step(cfg)(params, {"tokens": tokens})
logits, cache = make_decode_step(cfg)(params, cache, logits.argmax(-1)[:, None])
assert logits.shape == (2, cfg.vocab) and bool(logits.isfinite().all()) and int(cache["pos"]) == 33
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
dryrun.start_fake_group(4)
mesh = make_mesh((2, 2), ("data", "model"), "cpu")
with FakeTensorMode():
    step, args = dryrun.build_cell("internlm2-1.8b", ShapeSpec("smoke", "decode", 32, 4), mesh,
                                   cfg=get_smoke_config("internlm2-1.8b"))
    census = dryrun.Census(4)
    with census:
        step(*args)
assert census.record()["collectives"], census.record()
import torch.distributed as dist
dist.destroy_process_group()
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


def test_chip_smoke_imports_neither_jax_nor_repro():
    """``chip_smoke.py`` (which runs only on the card) names no module of
    jax or of the JAX package in any import, at any depth."""
    import ast

    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    bad = sorted(n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro"))
    assert not bad, bad
    assert any(n.startswith("repro_torch") for n in names)


def test_chip_smoke_binds_each_module_name_once():
    """Every phase of ``chip_smoke.py`` reads its constants from module
    globals: a name bound twice at module level would give an earlier
    phase a later phase's value."""
    import ast
    import collections

    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    bound = collections.Counter()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            bound[node.name] += 1
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for target in node.targets if isinstance(node, ast.Assign) else [node.target]:
                bound.update(n.id for n in ast.walk(target) if isinstance(n, ast.Name))
    assert len(bound) > 100
    assert sorted(name for name, n in bound.items() if n > 1) == []


_EXAMPLES_CODE = """
import glob, importlib.util, os, sys
for path in sorted(glob.glob(os.path.join(sys.argv[1], "examples_torch", "*.py"))):
    name = os.path.basename(path)[:-3]
    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    print("IMPORTED", name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LOADED", bad)
sys.exit(1 if bad else 0)
"""


def test_examples_import_neither_jax_nor_repro():
    """Importing every ``examples_torch/*.py`` loads neither jax nor any
    module of the JAX package."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    out = subprocess.run(
        [sys.executable, "-c", _EXAMPLES_CODE, ROOT], capture_output=True, text=True, env=env,
        timeout=300,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.count("IMPORTED") == 6, out.stdout


# what the machine with the card has beside the standard library
ALLOWED_IMPORTS = {"torch", "numpy", "scipy", "einops", "triton", "repro_torch"}


def _foreign_imports(path: str) -> list[str]:
    """``file:line module`` for each absolute import in ``path`` of a top
    package outside the standard library and ``ALLOWED_IMPORTS``."""
    import ast

    with open(path) as f:
        tree = ast.parse(f.read())
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            if top not in sys.stdlib_module_names and top not in ALLOWED_IMPORTS:
                found.append(f"{os.path.relpath(path, ROOT)}:{node.lineno} {name}")
    return found


def test_port_imports_only_what_the_card_machine_has():
    """Every import in ``src/repro_torch/``, ``examples_torch/`` and
    ``chip_smoke.py``, at any depth (inside functions too), names the
    standard library, torch, numpy, scipy, einops, triton or
    ``repro_torch``: nothing the machine with the card lacks (networkx
    among them)."""
    import glob

    paths = sorted(glob.glob(os.path.join(ROOT, "src", "repro_torch", "**", "*.py"),
                             recursive=True))
    paths += sorted(glob.glob(os.path.join(ROOT, "examples_torch", "*.py")))
    paths.append(os.path.join(ROOT, "chip_smoke.py"))
    assert len(paths) > 60
    bad = [hit for path in paths for hit in _foreign_imports(path)]
    assert not bad, bad
