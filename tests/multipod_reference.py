"""Shared by ``test_torch_dryrun_multipod*.py``: the port's ``train_4k`` dry
run on the multi-pod (2x16x16) mesh cut to a few layers, and the per-device
argument bytes the JAX package's rules give the same cell (parameters by
``param_shardings``, AdamW's ``mu`` and ``nu`` as the parameters and its
count replicated, the reference dry run's ``_opt_state_shardings``; the
batch by ``batch_sharding``), each leaf's shard shape times its itemsize."""
import dataclasses
import os

import jax
import numpy as np
import torch
from jax.sharding import AbstractMesh

import repro.configs as jax_configs
import repro.models.sharding as jsh
import repro.models.transformer as jax_tf
import repro_torch.configs as configs
from repro.configs.shapes import input_specs as jax_input_specs
from repro.training.optimizer import adamw_init as jax_adamw_init
from repro_torch.launch import dryrun

SHAPE = "train_4k"
MESH = ((2, 16, 16), ("pod", "data", "model"))


def _nbytes(shape, dtype) -> int:
    return int(np.prod(shape)) * np.dtype(dtype).itemsize


def reference_argument_bytes(arch: str, n_layers: int) -> int:
    """The JAX package's per-device bytes of the cell's arguments:
    parameters, optimizer state and batch, each leaf's shard shape."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import _opt_state_shardings
    finally:  # the module sets XLA_FLAGS for its own CLI
        os.environ.pop("XLA_FLAGS", None) if saved is None else os.environ.update(XLA_FLAGS=saved)
    mesh = AbstractMesh(*MESH)
    cfg = dataclasses.replace(jax_configs.get_config(arch), n_layers=n_layers)
    params = jax.eval_shape(lambda: jax_tf.init_params(cfg, jax.random.key(0)))
    params_sh = jsh.param_shardings(cfg, mesh)
    opt = jax.eval_shape(jax_adamw_init, params)
    shapes = jax.tree.leaves((params, opt))
    shardings = jax.tree.leaves((params_sh, _opt_state_shardings(params_sh, mesh)))
    assert len(shapes) == len(shardings)
    want = sum(_nbytes(s.shard_shape(x.shape), x.dtype) for x, s in zip(shapes, shardings))
    for x in jax_input_specs(cfg, SHAPE).values():
        want += _nbytes(jsh.batch_sharding(mesh, x.shape[0], x.ndim).shard_shape(x.shape),
                        x.dtype)
    return want


def multipod_train_cell(arch: str, n_layers: int, monkeypatch) -> dict:
    """The dry run's record of ``arch`` x train_4k on 2x16x16 at
    ``n_layers`` layers (the config cut where the dry run reads it), run in
    this process on one intra-op thread."""
    monkeypatch.setattr(dryrun, "get_config", lambda a: dataclasses.replace(
        configs.get_config(a), n_layers=n_layers))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return dryrun.run_cell(arch, SHAPE, True, None)
    finally:
        torch.set_num_threads(threads)


def check_cell(arch: str, n_layers: int, monkeypatch) -> None:
    rec = multipod_train_cell(arch, n_layers, monkeypatch)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["n_devices"] == 512 and rec["n_layers"] == n_layers
    assert rec["memory"]["argument_size_in_bytes"] == reference_argument_bytes(arch, n_layers)
