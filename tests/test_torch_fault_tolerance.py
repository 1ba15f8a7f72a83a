"""Fault tolerance on the port: every case of ``tests/test_fault_tolerance.py``
(checkpoint atomicity and crash windows, tuples, the retry predicate, the
elastic loop's backoff and straggler detection, the resumable data
pipeline, a deterministic resume — bit for bit on the CPU, as the
reference's), plus checkpoints crossing between the two packages with bf16
leaves (the bits equal both ways), and ``restore_checkpoint(device=)`` in
place of the reference's sharded restore."""
import os
import shutil
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.checkpoint as jax_ckpt
from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.checkpoint.store import all_steps
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch.elastic import InjectedFailure, run_loop
from repro_torch.models import init_params
from repro_torch.training.optimizer import adamw_init, tree_leaves
from repro_torch.training.step import make_train_step


def test_checkpoint_roundtrip(tmp_path):
    state = {
        "a": np.arange(12).reshape(3, 4).astype(np.float32),
        "nested": {"b": np.ones(5, np.int32), "c": [np.zeros(2), np.full(3, 7.0)]},
        "t": torch.arange(6, dtype=torch.float32).reshape(2, 3),
    }
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 5, state)
    restored, step = restore_checkpoint(d)
    assert step == 5
    np.testing.assert_array_equal(restored["a"], state["a"])
    np.testing.assert_array_equal(restored["nested"]["c"][1], state["nested"]["c"][1])
    assert restored["nested"]["b"].dtype == torch.int32
    assert torch.equal(restored["t"], state["t"])


def test_checkpoint_gc_keeps_last(tmp_path):
    d = str(tmp_path / "ckpt")
    for s in range(6):
        save_checkpoint(d, s, {"x": np.array([s])}, keep_last=2)
    assert all_steps(d) == [4, 5]


def test_checkpoint_no_partial_commit(tmp_path):
    """A .tmp dir must never be visible as a checkpoint."""
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 1, {"x": np.array([1])})
    os.makedirs(os.path.join(d, ".tmp-2"))  # simulated crash mid-save
    assert latest_step(d) == 1


def test_interrupted_commit_leaves_restorable_checkpoint(tmp_path):
    """Every crash window of the overwrite commit leaves a restorable latest
    checkpoint, and readers recover an orphaned .prev automatically."""
    d = str(tmp_path / "ckpt")
    step_dir = os.path.join(d, f"step_{1:012d}")
    save_checkpoint(d, 1, {"x": np.array([1])})

    # crash window A: old renamed aside, new not yet in place
    os.rename(step_dir, step_dir + ".prev")
    assert latest_step(d) == 1  # reader recovers the .prev
    restored, _ = restore_checkpoint(d, 1)
    np.testing.assert_array_equal(restored["x"], [1])

    # crash window B: new committed, stale .prev left behind
    save_checkpoint(d, 1, {"x": np.array([2])})
    shutil.copytree(step_dir, step_dir + ".prev")
    assert all_steps(d) == [1]  # stale .prev dropped, not double-counted
    restored, _ = restore_checkpoint(d, 1)
    np.testing.assert_array_equal(restored["x"], [2])  # new copy wins
    assert not os.path.exists(step_dir + ".prev")


def test_checkpoint_overwrite_same_step(tmp_path):
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 3, {"x": np.array([1])})
    save_checkpoint(d, 3, {"x": np.array([9])})
    restored, step = restore_checkpoint(d)
    assert step == 3
    np.testing.assert_array_equal(restored["x"], [9])


def test_checkpoint_tuple_roundtrip(tmp_path):
    """Tuples survive restore as tuples, lists as lists."""
    state = {
        "pair": (np.array([1.0]), np.array([2.0])),
        "mixed": [np.array([3]), (np.array([4]), np.array([5]))],
    }
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 1, state)
    restored, _ = restore_checkpoint(d)
    assert isinstance(restored["pair"], tuple)
    assert isinstance(restored["mixed"], list)
    assert isinstance(restored["mixed"][1], tuple)
    np.testing.assert_array_equal(restored["pair"][1], [2.0])
    np.testing.assert_array_equal(restored["mixed"][1][0], [4])
    assert jax.tree.structure(jax.tree.map(np.asarray, restored)) == jax.tree.structure(state)


def test_retryable_predicate_classification():
    from repro_torch.resilience import RetryableError, is_retryable

    assert is_retryable(InjectedFailure("node lost"))
    assert is_retryable(RetryableError("x"))
    assert is_retryable(RuntimeError("RESOURCE_EXHAUSTED: oom"))
    assert is_retryable(MemoryError())
    assert is_retryable(TimeoutError())
    assert is_retryable(OSError("disk blip"))
    assert not is_retryable(FileNotFoundError("gone"))
    assert not is_retryable(PermissionError("no"))
    assert not is_retryable(ValueError("shape mismatch"))
    assert not is_retryable(RuntimeError("plain bug"))


def test_run_loop_does_not_restart_on_permanent_failure(tmp_path):
    def step_fn(state, idx):
        if idx == 2:
            raise ValueError("permanent bug")
        return state

    with pytest.raises(ValueError):
        run_loop(0, step_fn, 5, ckpt_dir=str(tmp_path / "c"), ckpt_every=1)


def test_run_loop_backoff_between_restarts(tmp_path):
    """Consecutive restarts back off exponentially; a completed step resets."""
    sleeps = []
    fails = {"n": 0}

    def step_fn(state, idx):
        if idx == 1 and fails["n"] < 3:
            fails["n"] += 1
            raise InjectedFailure("flaky step")
        return state

    _, stats = run_loop(
        0,
        step_fn,
        3,
        ckpt_dir=str(tmp_path / "c"),
        ckpt_every=1,
        max_restarts=5,
        restart_backoff_s=0.1,
        sleep=sleeps.append,
    )
    assert stats.restarts == 3
    assert sleeps == pytest.approx([0.1, 0.2, 0.4])


def _make_trainer():
    cfg = get_smoke_config("internlm2-1.8b")
    step = make_train_step(cfg, lr=1e-3)
    params = init_params(cfg, 0, device="cpu")
    opt = adamw_init(params)
    data = SyntheticTokens(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=0)

    def step_fn(state, idx):
        p, o = state
        p, o, _ = step(p, o, data.batch(idx))
        return p, o

    return (params, opt), step_fn


def test_resume_is_deterministic(tmp_path):
    """Run 8 steps straight; run 8 steps with a crash at step 5 + restart;
    final params must match exactly (pure-function data pipeline + ckpt)."""
    state0, step_fn = _make_trainer()
    ref, _ = run_loop(state0, step_fn, 8, ckpt_dir=None)

    d = str(tmp_path / "ckpt")
    state0b, step_fn_b = _make_trainer()
    crashed = {"done": False}

    def injector(step):
        if step == 5 and not crashed["done"]:
            crashed["done"] = True
            raise InjectedFailure("simulated node loss")

    got, stats = run_loop(
        state0b,
        step_fn_b,
        8,
        ckpt_dir=d,
        ckpt_every=2,
        failure_injector=injector,
        state_to_tree=lambda s: {"p": s[0], "o": s[1]},
        tree_to_state=lambda t, s: (t["p"], t["o"]),
    )
    assert stats.restarts == 1
    for a, b in zip(tree_leaves(ref[0]), tree_leaves(got[0])):
        assert torch.equal(a, b)


def test_straggler_detection():
    def step_fn(state, idx):
        time.sleep(0.35 if idx == 7 else 0.01)
        return state

    _, stats = run_loop(0, step_fn, 10, straggler_factor=3.0)
    assert [s[0] for s in stats.stragglers] == [7]


def test_data_pipeline_deterministic_and_host_sharded():
    ds = SyntheticTokens(vocab=100, seq_len=16, global_batch=8, seed=1)
    b1, b2 = ds.batch(3), ds.batch(3)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(ds.batch(4)["tokens"], b1["tokens"])
    h0 = SyntheticTokens(vocab=100, seq_len=16, global_batch=8, seed=1, n_hosts=2, host_id=0)
    h1 = SyntheticTokens(vocab=100, seq_len=16, global_batch=8, seed=1, n_hosts=2, host_id=1)
    assert h0.batch(0)["tokens"].shape == (4, 16)
    assert not np.array_equal(h0.batch(0)["tokens"], h1.batch(0)["tokens"])


def test_restore_with_device_in_place_of_shardings(tmp_path):
    """The elastic re-scale path: the reference restores onto a mesh's
    shardings, the port onto a device; the host (no device) is the
    reference's plain restore."""
    d = str(tmp_path / "ckpt")
    state = {"w": np.arange(16, dtype=np.float32).reshape(4, 4),
             "b": torch.ones(3, dtype=torch.bfloat16)}
    save_checkpoint(d, 1, state)
    restored, _ = restore_checkpoint(d, device="cpu")
    assert restored["w"].device.type == "cpu"
    np.testing.assert_array_equal(restored["w"].numpy(), state["w"])
    assert restored["b"].dtype == torch.bfloat16 and torch.equal(restored["b"], state["b"])
    meta, _ = restore_checkpoint(d, device="meta")
    assert meta["w"].device.type == "meta" and meta["w"].shape == (4, 4)


def _bf16_state(seed=0):
    rng = np.random.default_rng(seed)
    bits = rng.integers(-2**15, 2**15, (3, 5)).astype(np.int16)
    bits[(bits & 0x7F80) == 0x7F80] = 0  # no NaN or inf payloads
    return {"w": bits.view(ml_dtypes.bfloat16), "f": rng.standard_normal(4).astype(np.float32),
            "n": {"count": np.array(7, np.int32)}, "pair": (np.arange(3), np.ones(2))}


def test_jax_checkpoint_with_bf16_restores_in_the_port(tmp_path):
    """A checkpoint the JAX package writes (bf16 as numpy ``V2``) restores
    here with its bf16 leaves as ``torch.bfloat16``, the same bits."""
    d = str(tmp_path / "ckpt")
    state = _bf16_state()
    jax_ckpt.save_checkpoint(d, 3, jax.tree.map(jnp.asarray, state))
    restored, step = restore_checkpoint(d)
    assert step == 3 and isinstance(restored["pair"], tuple)
    assert restored["w"].dtype == torch.bfloat16
    assert torch.equal(restored["w"].view(torch.int16), torch.from_numpy(state["w"].view(np.int16)))
    np.testing.assert_array_equal(restored["f"].numpy(), state["f"])
    assert int(restored["n"]["count"]) == 7


def test_port_checkpoint_with_bf16_restores_in_jax(tmp_path):
    """A checkpoint the port writes restores in the JAX package: the same
    tree and bits, its bf16 leaves as the ``V2`` bytes the reference's own
    restore gives for a bf16 leaf it wrote itself."""
    state = _bf16_state(1)
    port_state = {**state, "w": torch.from_numpy(state["w"].view(np.int16).copy()).view(
        torch.bfloat16)}
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    save_checkpoint(ours, 2, port_state)
    jax_ckpt.save_checkpoint(theirs, 2, jax.tree.map(jnp.asarray, state))
    got, step = jax_ckpt.restore_checkpoint(ours)
    want, _ = jax_ckpt.restore_checkpoint(theirs)
    assert step == 2
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert got["w"].dtype.kind == want["w"].dtype.kind == "V"
    assert got["w"].tobytes() == want["w"].tobytes() == state["w"].tobytes()
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(state)):  # as the port was given them
        assert a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize
        assert a.tobytes() == b.tobytes()


def test_trained_state_roundtrips_through_both_packages(tmp_path):
    """A bf16 model's parameters and AdamW state, saved by the port,
    restored by JAX, saved again by JAX and restored by the port: every
    leaf's bits unchanged."""
    import dataclasses

    cfg = dataclasses.replace(get_smoke_config("qwen3-moe-235b-a22b"), dtype="bfloat16")
    params = init_params(cfg, 0, device="cpu")
    state = {"params": params, "opt": adamw_init(params)}
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    save_checkpoint(a, 1, state)
    tree, _ = jax_ckpt.restore_checkpoint(a)
    jax_ckpt.save_checkpoint(b, 1, tree)
    back, _ = restore_checkpoint(b)
    for got, want in zip(tree_leaves(back), tree_leaves(state)):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want)
