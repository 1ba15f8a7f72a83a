"""Training sharded over a ``DeviceMesh`` (4 gloo processes on the CPU, one
spawn for the steps and one for ``launch.train --ranks``): two train
steps (``make_train_step``: the backward through DTensors, each gradient
brought to its parameter's placements, the global-norm clip, AdamW or
Adafactor on the shards) equal the one-process port's steps, loss for
loss and parameter for parameter, in fp32 within 1e-4 (the port's steps
are held to JAX in ``test_torch_train_step.py``): internlm2 on a (2, 2)
mesh and Qwen3-MoE on (1, 4) under both optimizers, hymba (attention and
SSM heads) on (2, 2), Qwen3-MoE on (2, 2) at a capacity factor of E / K, where no expert drops a pair, so the
data shards' capacities keep what the whole batch's keeps, and Qwen3-MoE
on (4, 1), whose 'model' axis of one takes the plain MoE path with each
rank's tokens its own and the whole batch's capacity.  Then the dry
run's census of a smoke step on a fake (2, 2) mesh equals the collectives
that rank 0 really issues in the gloo run, counted by the same mode, and
``launch.train --ranks 4 --model-parallel 2`` logs the one-process run's
losses and writes checkpoints that one process restores and resumes."""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.configs as configs
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.data import SyntheticTokens
from repro_torch.launch import train as train_mod
from repro_torch.launch.ranks import run_ranks
from repro_torch.models import init_params
from repro_torch.training import make_train_step
from repro_torch.training.optimizer import OPTIMIZERS, tree_leaves

TOL = 1e-4
STEPS, SEQ, BATCH = 2, 32, 4
CASES = [  # (arch, mesh, optimizer, capacity factor or None)
    ("internlm2-1.8b", (2, 2), "adamw", None),
    ("internlm2-1.8b", (2, 2), "adafactor", None),
    ("qwen3-moe-235b-a22b", (1, 4), "adamw", None),
    ("qwen3-moe-235b-a22b", (1, 4), "adafactor", None),
    ("qwen3-moe-235b-a22b", (2, 2), "adamw", "E/K"),
    ("hymba-1.5b", (2, 2), "adamw", None),  # the SSM's convolution and scan on shards
    ("qwen3-moe-235b-a22b", (4, 1), "adamw", None),  # the plain MoE path on token shards
]
CENSUS = [  # smoke steps whose collectives the dry run must predict
    ("internlm2-1.8b", ShapeSpec("smoke_train", "train", SEQ, BATCH)),
    ("qwen3-moe-235b-a22b", ShapeSpec("smoke_prefill", "prefill", SEQ, BATCH)),
    ("hymba-1.5b", ShapeSpec("smoke_decode", "decode", SEQ, BATCH)),
]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke sizes are paced by dispatch, not arithmetic: one intra-op
    thread, so the test leaves the host's cores to the other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(arch, capacity):
    cfg = configs.get_smoke_config(arch)
    if capacity == "E/K":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    return cfg


def _whole(t) -> np.ndarray:
    from torch.distributed.tensor import DTensor

    return (t.full_tensor() if isinstance(t, DTensor) else t).detach().numpy()


def _train_rank(group, device):
    """One rank: ``STEPS`` sharded steps of every case, then the census of
    every ``CENSUS`` step on a (2, 2) mesh (``dryrun.build_cell``)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import sharding as sh

    out = {}
    for arch, shape, optimizer, capacity in CASES:
        cfg = _cfg(arch, capacity)
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        params = sh.distribute_params(init_params(cfg, 0, device="cpu"), mesh,
                                      sh.param_shardings(cfg, mesh))
        state = OPTIMIZERS[optimizer][0](params)
        step = make_train_step(cfg, optimizer=optimizer)
        data = SyntheticTokens(cfg.vocab, SEQ, BATCH, seed=0)
        losses = []
        for i in range(STEPS):
            batch = {k: sh.distribute(torch.as_tensor(v), sh.batch_sharding(mesh, BATCH, 2))
                     for k, v in data.batch(i).items()}
            params, state, metrics = step(params, state, batch)
            losses.append(float(_whole(metrics["loss"])))
        out[(arch, shape, optimizer, capacity)] = {
            "losses": losses, "params": [_whole(p) for p in tree_leaves(params)],
            "state": [_whole(s) for s in tree_leaves(state)],
        }
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    for arch, spec in CENSUS:
        step, args = dryrun.build_cell(arch, spec, mesh, cfg=configs.get_smoke_config(arch))
        census = dryrun.Census()
        with census:
            step(*args)
        out[("census", arch)] = census.record()
    return out


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    return run_ranks(_train_rank, 4, device="cpu", workdir=tmp_path_factory.mktemp("pg"),
                     timeout=600)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1][0]}x{c[1][1]}-{c[2]}"
                         + ("-no_drop" if c[3] else ""))
def test_sharded_train_steps_equal_one_process(trained, case):
    arch, shape, optimizer, capacity = case
    cfg = _cfg(arch, capacity)
    params = init_params(cfg, 0, device="cpu")
    state = OPTIMIZERS[optimizer][0](params)
    step = make_train_step(cfg, optimizer=optimizer)
    data = SyntheticTokens(cfg.vocab, SEQ, BATCH, seed=0)
    losses = []
    for i in range(STEPS):
        params, state, metrics = step(params, state, {k: torch.as_tensor(v) for k, v in
                                                      data.batch(i).items()})
        losses.append(float(metrics["loss"]))
    for r in trained:
        got = r.result[case]
        np.testing.assert_allclose(got["losses"], losses, rtol=TOL, atol=TOL)
        for g, w in zip(got["params"], tree_leaves(params)):
            np.testing.assert_allclose(g, w.numpy(), rtol=TOL, atol=TOL)
        for g, w in zip(got["state"], tree_leaves(state)):
            np.testing.assert_allclose(g, w.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch,spec", CENSUS, ids=[f"{a}-{s.kind}" for a, s in CENSUS])
def test_dry_run_census_equals_the_gloo_run(trained, arch, spec):
    """The same step on a fake (2, 2) group in this process, under fake
    tensors: the collectives by kind (count and bytes) and the FLOPs equal
    what rank 0 counted running it; the group is destroyed after."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh

    dryrun.start_fake_group(4)
    try:
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        with FakeTensorMode():
            step, args = dryrun.build_cell(arch, spec, mesh, cfg=configs.get_smoke_config(arch))
            census = dryrun.Census()
            with census:
                step(*args)
        fake = census.record()
    finally:
        dist.destroy_process_group()
    real = trained[0].result[("census", arch)]
    assert fake["collectives"] == real["collectives"]
    assert fake["collectives"]
    assert (fake["flops"], fake["flops_per_device"]) == (real["flops"], real["flops_per_device"])


def _losses(out: str) -> list[float]:
    return [float(l.split("loss")[1].split()[0]) for l in out.splitlines() if l.startswith("step ")]


def test_launch_train_over_ranks_equals_one_process_and_restores(tmp_path, capfd):
    argv = ["--arch", "internlm2-1.8b", "--smoke", "--steps", "4", "--ckpt-every", "2",
            "--seq-len", "32", "--global-batch", "4", "--device", "cpu"]
    sharded = train_mod.main(argv + ["--ranks", "4", "--model-parallel", "2",
                                     "--ckpt-dir", str(tmp_path / "sharded")])
    out = capfd.readouterr().out
    assert "done: 4 steps, 0 restarts" in out
    one = train_mod.main(argv + ["--ckpt-dir", str(tmp_path / "one")])
    out_one = capfd.readouterr().out
    assert len(_losses(out)) == 2 and _losses(out) == _losses(out_one)
    for g, w in zip(tree_leaves(sharded), tree_leaves(one)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=TOL, atol=TOL)
    # the sharded run's checkpoint: whole tensors, restored in one process
    from repro_torch.checkpoint import latest_step, restore_checkpoint

    assert latest_step(str(tmp_path / "sharded")) == 4
    tree, _ = restore_checkpoint(str(tmp_path / "sharded"))
    for g, w in zip(tree_leaves(tree["params"]), tree_leaves(sharded)):
        assert torch.equal(g, w)
    resumed = train_mod.main(argv[:4] + ["6"] + argv[5:] + ["--ckpt-dir",
                                                            str(tmp_path / "sharded")])
    assert "done: 2 steps, 0 restarts" in capfd.readouterr().out
    assert all(np.isfinite(t.numpy()).all() for t in tree_leaves(resumed))

