"""The port's multi-pod dry run (``repro_torch.launch.dryrun``), the
counterpart of ``test_dryrun_integration.py``: internlm2-1.8b x
decode_32k on the 16x16 and the 2x16x16 meshes, each in a subprocess
(a ``fake`` group of 256 or 512 ranks, fake tensors), must record
status ok, its devices, FLOPs, wire bytes, temp bytes and at least one
collective kind, hold its peak resident memory far below the bytes it
describes (no storage), and give per-device argument bytes equal to the
JAX package's shard shapes (``param_shardings``, ``batch_sharding`` and
the dry run's cache axes on an ``AbstractMesh``) times their itemsize,
and global FLOPs equal to ``FlopCounterMode`` on the unsharded step.
Then every ``--opt`` runs a smoke step on a fake (2, 2) mesh in this
process."""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, NamedSharding

import repro.configs as jax_configs
import repro.models.sharding as jsh
import repro.models.transformer as jax_tf
import repro_torch.configs as configs
from repro_torch.configs.shapes import ShapeSpec, cache_specs, input_specs
from repro_torch.launch import dryrun
from repro_torch.models import init_params
from repro_torch.training import make_decode_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH, SHAPE = "internlm2-1.8b", "decode_32k"

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke sizes are paced by dispatch, not arithmetic: one intra-op
    thread, so the test leaves the host's cores to the other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_RUN = """
import json, resource, sys
from repro_torch.launch import dryrun
try:
    dryrun.main(sys.argv[1:])
except SystemExit as e:
    code = e.code
print("MAXRSS_KB", resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)
sys.exit(code)
"""


@pytest.fixture(scope="module", params=[False, True], ids=["16x16", "2x16x16"])
def cell(request, tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    args = [sys.executable, "-c", _RUN, "--arch", ARCH, "--shape", SHAPE, "--out", str(out)]
    if request.param:
        args.append("--multi-pod")
    run = subprocess.run(args, capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert run.returncode == 0, f"stdout:\n{run.stdout}\nstderr:\n{run.stderr}"
    mesh = "2x16x16" if request.param else "16x16"
    rss = int(run.stdout.split("MAXRSS_KB")[1].split()[0]) * 1024
    return request.param, json.load(open(out / f"{ARCH}_{SHAPE}_{mesh}.json")), rss


def test_dryrun_cell_runs(cell):
    multi_pod, rec, rss = cell
    assert rec["status"] == "ok"
    assert rec["n_devices"] == (512 if multi_pod else 256)
    assert rec["n_layers"] == configs.get_config(ARCH).n_layers
    assert rec["flops"] > 0 and rec["flops_per_device"] > 0
    assert rec["wire_bytes"] >= 0
    assert "temp_size_in_bytes" in rec["memory"]
    assert len(rec["collectives"]) >= 1  # the census found at least one kind
    assert rec["trace_s"] > 0
    # no storage: the process held a sliver of what one device's shards take
    assert rss < rec["memory"]["argument_size_in_bytes"] / 4


def _nbytes(shape, dtype) -> int:
    return int(np.prod(shape)) * np.dtype(dtype).itemsize


def test_argument_bytes_are_the_reference_shard_sizes(cell):
    """Parameters, the tokens and the cache, each leaf's reference shard
    shape times its itemsize, summed."""
    multi_pod, rec, _ = cell
    sizes, names = ((2, 16, 16), ("pod", "data", "model")) if multi_pod else \
        ((16, 16), ("data", "model"))
    mesh = AbstractMesh(sizes, names)
    cfg = jax_configs.get_config(ARCH)
    shapes = jax.eval_shape(lambda: jax_tf.init_params(cfg, jax.random.key(0)))
    shardings = jsh.param_shardings(cfg, mesh)
    want = sum(_nbytes(s.shard_shape(x.shape), x.dtype) for x, s in
               zip(jax.tree.leaves(shapes), jax.tree.leaves(shardings)))
    tokens = (128, 1)  # decode_32k: batch 128, one new token
    want += _nbytes(jsh.batch_sharding(mesh, 128, 2).shard_shape(tokens), np.int32)
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import _cache_logical_axes
    finally:
        os.environ.pop("XLA_FLAGS", None) if saved is None else os.environ.update(XLA_FLAGS=saved)
    cache = jax.eval_shape(lambda: jax_tf.init_kv_cache(cfg, 128, 32768))
    axes = _cache_logical_axes(cfg)
    for key, x in cache.items():
        spec = jsh._fit_spec(jsh.spec_for(*axes[key], mesh=mesh), x.shape, mesh)
        want += _nbytes(NamedSharding(mesh, spec).shard_shape(x.shape), x.dtype)
    assert rec["memory"]["argument_size_in_bytes"] == want


def test_global_flops_are_the_unsharded_steps(cell):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    _, rec, _ = cell
    cfg = configs.get_config(ARCH)
    counter = FlopCounterMode(display=False)
    with FakeTensorMode():
        params = dryrun._like(init_params(cfg, device="meta"), "cpu")
        cache = dryrun._like(cache_specs(cfg, SHAPE), "cpu")
        tokens = dryrun._like(input_specs(cfg, SHAPE), "cpu")["tokens"]
        with counter:
            make_decode_step(cfg)(params, cache, tokens)
    assert rec["flops"] == counter.get_total_flops()
    assert rec["flops"] > rec["flops_per_device"] * 16  # split over every device at least 16 ways


@pytest.mark.parametrize("opt", [o for o in dryrun.OPTS if o != "donate"])
def test_every_opt_runs_a_smoke_step(opt):
    """Each knob of ``build_cell`` on a fake 4-rank mesh in this process
    (the group destroyed after): the step runs on fake tensors and the
    census sees collectives."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.mesh import make_mesh

    kind = {"serve_shardings": "decode", "kv_none": "decode", "kv_seq": "decode",
            "remat_dots": "train", "remat_none": "train"}.get(opt, "prefill")
    arch = "qwen3-moe-235b-a22b" if opt in ("gather_weights", "kv_seq") else "hymba-1.5b"
    cfg = configs.get_smoke_config(arch)
    # "seq" splits the cache's slots over 'model', which must not split its
    # kv heads too: 2 kv heads on a model axis of 4 are replicated
    shape = (1, 4) if opt == "kv_seq" else (2, 2)
    dryrun.start_fake_group(4)
    try:
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        with FakeTensorMode():
            step, args = dryrun.build_cell(arch, ShapeSpec("smoke", kind, 32, 4), mesh, cfg=cfg,
                                           opts=(opt,))
            census = dryrun.Census(4)
            with census:
                out = step(*args)
        assert census.record()["collectives"]
        assert dryrun._local_bytes(out) > 0
    finally:
        dist.destroy_process_group()


def test_unknown_opts_are_refused():
    with pytest.raises(ValueError, match="unknown opt"):
        dryrun.cell_config(ARCH, ("fast",))
