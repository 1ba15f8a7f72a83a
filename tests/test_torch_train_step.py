"""One ``make_train_step`` step of the port against the JAX package's on
the CPU, for each of the ten architectures at smoke size in fp32 and
each optimizer: the metrics (``loss``, ``grad_norm``, ``nll``, ``aux``),
the updated parameters and the optimizer state, within 1e-4 (the forward's
tolerance); then ``launch.train``'s trainer and entry point, and the
training, checkpoint and model packages' exported names.  JAX's
``init_params(cfg, jax.random.key(0))`` is carried across by
``params_from_reference``; the port updates its parameters in place, so
each run starts from its own copy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
import repro.models.transformer as jax_tf
import repro_torch.configs as configs
from repro.training.optimizer import OPTIMIZERS as JAX_OPTIMIZERS
from repro.training.step import make_train_step as jax_make_train_step
from repro_torch.launch import train as train_mod
from repro_torch.models.convert import params_from_reference
from repro_torch.training import make_train_step
from repro_torch.training.optimizer import OPTIMIZERS

from test_torch_train import ARCHS, close, flat, train_batch

TOL = 1e-4


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_equals_jax(arch, optimizer):
    jcfg, tcfg = jax_configs.get_smoke_config(arch), configs.get_smoke_config(arch)
    jp = jax_tf.init_params(jcfg, jax.random.key(0))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    batch = train_batch(tcfg)
    jinit, _ = JAX_OPTIMIZERS[optimizer]
    jp2, jstate, jm = jax_make_train_step(jcfg, optimizer=optimizer)(
        jp, jinit(jp), {k: jnp.asarray(v) for k, v in batch.items()})
    tinit, _ = OPTIMIZERS[optimizer]
    tp2, tstate, tm = make_train_step(tcfg, optimizer=optimizer)(tp, tinit(tp), batch)
    assert sorted(tm) == sorted(jm) == ["aux", "grad_norm", "loss", "nll"]
    for k in jm:
        close(tm[k], jm[k], k)
    assert float(tm["grad_norm"]) > 0
    jflat, tflat = flat(jp2), flat(tp2)
    assert sorted(tflat) == sorted(jflat)
    for k in jflat:
        assert tflat[k] is flat(tp)[k]  # updated in place
        close(tflat[k], jflat[k], f"param {k}")
    jst, tst = flat(jax.tree.map(np.asarray, jstate)), flat(tstate)
    assert sorted(tst) == sorted(jst)
    for k in jst:
        assert tst[k].shape == jst[k].shape and tst[k].dtype == getattr(torch, str(jst[k].dtype))
        close(tst[k], jst[k], f"state {k}")


def test_build_trainer_steps_and_its_optimizer_state():
    cfg = configs.get_smoke_config("qwen3-moe-235b-a22b")
    step, opt_init = train_mod.build_trainer(cfg, "cpu", lr=1e-3, optimizer="adafactor")
    from repro_torch.models import init_params

    params = init_params(cfg, 0, device="cpu")
    before = {k: v.clone() for k, v in flat(params).items()}
    state = opt_init(params)
    assert "vr" in state["v"]["layers"]["moe"]["wi"]
    params, state, m = step(params, state, train_batch(cfg))
    assert int(state["count"]) == 1 and np.isfinite(float(m["loss"]))
    assert any(not torch.equal(v, before[k]) for k, v in flat(params).items())


def test_train_main_runs_and_checkpoints(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    argv = ["--arch", "internlm2-1.8b", "--smoke", "--steps", "4", "--ckpt-every", "2",
            "--seq-len", "32", "--global-batch", "2", "--device", "cpu", "--ckpt-dir", ckpt]
    params = train_mod.main(argv)
    out = capsys.readouterr().out
    assert "done: 4 steps, 0 restarts" in out and "step     0 loss" in out
    from repro_torch.checkpoint import latest_step, restore_checkpoint

    assert latest_step(ckpt) == 4
    tree, _ = restore_checkpoint(ckpt)
    for k, v in flat(params).items():
        assert torch.equal(flat(tree["params"])[k], v)
    # a second run on the same directory resumes at step 4: nothing left to do
    train_mod.main(argv)
    assert "done: 0 steps" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "hymba-1.5b"])
def test_train_main_runs_and_checkpoints_the_ssm_archs(arch, tmp_path, capsys):
    """``launch.train.main`` at a Mamba and a hybrid smoke config: the
    steps run, the loss is finite, and the checkpoint holds the trained
    parameters."""
    ckpt = str(tmp_path / "ckpt")
    params = train_mod.main(["--arch", arch, "--smoke", "--steps", "3", "--ckpt-every", "3",
                             "--seq-len", "32", "--global-batch", "2", "--device", "cpu",
                             "--ckpt-dir", ckpt])
    out = capsys.readouterr().out
    assert "done: 3 steps, 0 restarts" in out
    losses = [float(l.split("loss")[1].split()[0]) for l in out.splitlines()
              if l.startswith("step ")]
    assert losses and all(np.isfinite(losses))
    from repro_torch.checkpoint import latest_step, restore_checkpoint

    assert latest_step(ckpt) == 3
    tree, _ = restore_checkpoint(ckpt)
    assert "ssm" in tree["params"]["layers"]
    for k, v in flat(params).items():
        assert torch.equal(flat(tree["params"])[k], v)


def test_model_parallel_raises_naming_the_roadmap_item():
    """``--model-parallel`` now builds a mesh over the processes' group (the
    roadmap item is done: ``test_torch_sharded_train.py`` runs it over 4);
    one process is a one-rank group, which a model axis of 2 does not
    divide, so it raises (the group it started is destroyed)."""
    import torch.distributed as dist

    try:
        with pytest.raises(ValueError, match="model axis 2 does not divide the 1 ranks"):
            train_mod.main(["--smoke", "--model-parallel", "2", "--device", "cpu"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.parametrize("module", ["training", "checkpoint", "models", ""])
def test_exports_equal_jax(module):
    import importlib

    ref = importlib.import_module("repro" + (f".{module}" if module else ""))
    port = importlib.import_module("repro_torch" + (f".{module}" if module else ""))
    assert sorted(port.__all__) == sorted(ref.__all__)
    for name in port.__all__:
        assert hasattr(port, name), name
