"""The port's examples (``examples_torch/``) against the JAX package's
(``examples/``, loaded by path and run unedited) on the CPU, on the same
inputs: the plan and cost lines they print are equal letter for letter,
the port's products are within 1e-5 of numpy's, and where a model runs,
the JAX package's parameters are carried across
(``models.convert.params_from_reference``) and the results are within
1e-4.  ``train_100m``'s resume after a stop is held bit for bit to an
uninterrupted run, and every example raises without a card unless it is
given ``--device cpu``."""
import dataclasses
import importlib.util
import os
import re

import jax
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
import repro.core.matrices as jax_matrices
import repro.models.transformer as jax_tf
import repro_torch.configs as configs
import repro_torch.core.matrices as matrices
from repro.training.step import make_prefill_step as jax_make_prefill_step
from repro_torch.models.convert import params_from_reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ("quickstart", "select_quickstart", "amg_partition_study", "moe_comm_planning",
            "transformer_decode", "train_100m")
TOL = 1e-4


def load(name: str, port: bool):
    """The example ``name`` of the port (``examples_torch/``) or of the
    JAX package (``examples/``), as a fresh module."""
    folder = "examples_torch" if port else "examples"
    spec = importlib.util.spec_from_file_location(
        f"{folder}_{name}", os.path.join(ROOT, folder, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ported_params(tree):
    return params_from_reference(jax.tree.map(np.asarray, tree), device="cpu")


def loss_recorder(make_step, losses: list):
    """``make_step`` whose steps also hand each step's loss to ``losses``
    (a host callback, so it works inside ``jax.jit``)."""
    def make(*args, **kwargs):
        inner = make_step(*args, **kwargs)

        def step(*a):
            out = inner(*a)
            jax.debug.callback(lambda v: losses.append(float(v)), out[-1]["loss"])
            return out

        return step

    return make


# ---------------------------------------------------------------------------
# SpGEMM examples
# ---------------------------------------------------------------------------
def _table(out: str, drop=()) -> list[str]:
    """The printed lines, without those that report execution (which the
    JAX package skips on one device and the port always runs)."""
    return [line for line in out.splitlines()
            if line.strip() and not any(line.startswith(d) for d in drop)]


def test_quickstart_plans_as_jax(capsys, monkeypatch):
    """Fig. 1 and the seven plans print as the JAX package's, on MCL-dip at
    scale 0.1 in both (the example's own scale 0.2 runs on the card in
    ``chip_smoke.py``), and ``auto`` executes within 1e-5 of numpy."""
    real_jax, real_port = jax_matrices.mcl_instance, matrices.mcl_instance
    monkeypatch.setattr(jax_matrices, "mcl_instance", lambda name, scale: real_jax(name, 0.1))
    monkeypatch.setattr(matrices, "mcl_instance", lambda name, scale: real_port(name, 0.1))
    load("quickstart", port=False).main()
    want = capsys.readouterr().out
    out = load("quickstart", port=True).main(["--device", "cpu"])
    got = capsys.readouterr().out
    execution = ("executed", "(execution skipped")
    assert _table(got, execution) == _table(want, execution)
    assert "selected model:" in got and out["handles"]["auto"].model in got
    np.testing.assert_allclose(out["c"], out["a"].astype(np.float64) @ out["b"],
                               rtol=1e-5, atol=1e-5)


def test_select_quickstart_sweeps_as_jax(capsys):
    """The sweep table prints as the JAX package's (the port adds each
    executor's error to the notes; the JAX package runs none on one device),
    and every product, the sweep's and the compile-once demo's, is within
    1e-5 of numpy with no LRU miss after the compile."""
    load("select_quickstart", port=False).main()
    want = capsys.readouterr().out
    out = load("select_quickstart", port=True).main(["--device", "cpu"])
    got = capsys.readouterr().out
    demo = ("compile-once runtime", "(iterated-multiply demo skipped")
    strip = lambda lines: [re.sub(r", executor err [0-9.e+-]+", "", line) for line in lines]
    assert strip(_table(got, demo)) == _table(want, demo)
    assert all(r["exec_max_err"] <= 1e-5 for r in out["records"]), out["records"]
    it = out["iterated"]
    assert it["lru_misses"] == 0 and it["calls"] == len(it["products"]) == 10
    inst = it["handle"].instance
    for a_vals, b_vals, c in it["products"]:
        a = np.zeros(inst.a.shape); a[inst.a.coo()] = a_vals
        b = np.zeros(inst.b.shape); b[inst.b.coo()] = b_vals
        np.testing.assert_allclose(c.numpy(), a @ b, rtol=1e-5, atol=1e-5)


def test_amg_partition_study_prints_as_jax(capsys):
    argv = ["--n", "6", "--p", "4"]
    want_results = load("amg_partition_study", port=False).main(argv)
    want = capsys.readouterr().out
    got_results = load("amg_partition_study", port=True).main(argv + ["--device", "cpu"])
    assert capsys.readouterr().out == want
    assert want_results is None and len(got_results) == 16


def test_amg_partition_study_refuses_a_grid_as_jax():
    """n = 5 is no multiple of the 3 x 3 x 3 aggregates: both raise."""
    with pytest.raises(ValueError, match="not divisible by agg=3"):
        load("amg_partition_study", port=False).main(["--n", "5", "--p", "4"])
    with pytest.raises(ValueError, match="not divisible by agg=3"):
        load("amg_partition_study", port=True).main(["--n", "5", "--p", "4", "--device", "cpu"])


def test_moe_comm_planning_as_jax(capsys, monkeypatch):
    """The placement, cut costs and imbalances print exactly as the JAX
    package's; the loss with the placement installed is within 1e-4 of
    its, with its parameters carried across."""
    ref = load("moe_comm_planning", port=False)
    jax_losses = []
    real = ref.train_loss

    def recorded(params, cfg, batch):
        loss, aux = real(params, cfg, batch)
        jax.debug.callback(lambda v: jax_losses.append(float(v)), loss)
        return loss, aux

    monkeypatch.setattr(ref, "train_loss", recorded)
    ref.main()
    want = capsys.readouterr().out
    port = load("moe_comm_planning", port=True)
    cfg = port.smoke_moe_config()
    jcfg = dataclasses.replace(
        jax_configs.get_smoke_config("qwen3-moe-235b-a22b"),
        moe=ref.MoEConfig(n_experts=16, top_k=2, d_ff_expert=64))
    out = port.run(cfg, ported_params(jax_tf.init_params(jcfg, jax.random.key(0))))
    got = capsys.readouterr().out
    plan_lines = lambda s: [line for line in s.splitlines() if not line.startswith("model runs")]
    assert plan_lines(got) == plan_lines(want)
    assert len(jax_losses) == 1
    assert abs(out["loss"] - jax_losses[0]) <= TOL, (out["loss"], jax_losses)


# ---------------------------------------------------------------------------
# LM examples
# ---------------------------------------------------------------------------
def test_transformer_decode_greedy_as_jax(capsys):
    """internlm2 smoke, fp32, greedy: the prefill's logits within 1e-4 of
    the JAX package's and the decoded tokens equal to its example's."""
    argv = ["--arch", "internlm2-1.8b", "--smoke", "--batch", "2", "--prompt-len", "16",
            "--decode-tokens", "6", "--seed", "0"]
    want_toks = np.asarray(load("transformer_decode", port=False).main(argv))
    jcfg = jax_configs.get_smoke_config("internlm2-1.8b")
    jparams = jax_tf.init_params(jcfg, jax.random.key(0))
    prompts = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 16)).astype(np.int32)
    want_logits, _ = jax_make_prefill_step(jcfg)(jparams, {"tokens": prompts})
    port = load("transformer_decode", port=True)
    out = port.generate(configs.get_smoke_config("internlm2-1.8b"), ported_params(jparams),
                        prompts, 6)
    np.testing.assert_allclose(out["prefill_logits"].numpy(), np.asarray(want_logits),
                               rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(out["tokens"].numpy(), want_toks)
    port.main(argv + ["--device", "cpu"])
    assert "first sequence:" in capsys.readouterr().out


def test_transformer_decode_samples_from_its_seed():
    """With a temperature, the tokens are drawn by a generator seeded from
    ``--seed``: the same seed draws the same tokens, another seed others,
    and every token is in the vocabulary."""
    port = load("transformer_decode", port=True)
    argv = ["--smoke", "--batch", "2", "--prompt-len", "8", "--decode-tokens", "12",
            "--temperature", "1.5", "--device", "cpu"]
    a, b = port.main(argv + ["--seed", "3"]), port.main(argv + ["--seed", "3"])
    c = port.main(argv + ["--seed", "4"])
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (2, 12) and int(a.min()) >= 0 and int(a.max()) < 256


def test_transformer_decode_model_parallel_as_launch_train():
    """``--model-parallel 2`` builds a mesh over the process group, as
    ``launch.train`` does; one process does not divide into 2, so it
    raises (the group it started is destroyed)."""
    import torch.distributed as dist

    port = load("transformer_decode", port=True)
    try:
        with pytest.raises(ValueError, match="model axis 2 does not divide the 1 ranks"):
            port.main(["--smoke", "--model-parallel", "2", "--device", "cpu"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _tiny(cfg_module):
    """A 2-layer, d = 64, vocab-512 internlm2 (fp32) of either package."""
    return dataclasses.replace(
        cfg_module.get_config("internlm2-1.8b"), name="repro-100m-tiny", n_layers=2,
        d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128, vocab=512,
        dtype="float32")


def _train_argv(tmp_path, tag: str, steps: int) -> list[str]:
    return ["--steps", str(steps), "--seq-len", "32", "--global-batch", "2",
            "--ckpt-dir", str(tmp_path / f"ckpt_{tag}"), "--log", str(tmp_path / f"{tag}.jsonl")]


def test_train_100m_losses_as_jax(tmp_path, monkeypatch, capsys):
    """3 steps of the example with ``model_100m`` cut to 2 layers, d = 64,
    vocab 512 in both packages: every step's loss within 1e-4 of JAX's."""
    ref = load("train_100m", port=False)
    port = load("train_100m", port=True)
    monkeypatch.setattr(ref, "model_100m", lambda: _tiny(jax_configs))
    monkeypatch.setattr(port, "model_100m", lambda: _tiny(configs))
    jax_losses = []
    monkeypatch.setattr(ref, "make_train_step", loss_recorder(ref.make_train_step, jax_losses))
    ref.main(_train_argv(tmp_path, "jax", 3))
    jparams = jax_tf.init_params(_tiny(jax_configs), jax.random.key(0))
    args = port.parse_args(_train_argv(tmp_path, "port", 3) + ["--device", "cpu"])
    out = port.train(port.model_100m(), args, torch.device("cpu"), params=ported_params(jparams))
    assert len(jax_losses) == 3
    got = [out["losses"][i] for i in range(3)]
    np.testing.assert_allclose(got, jax_losses, rtol=0, atol=TOL)
    assert [r["step"] for r in out["records"]] == [0, 2]
    assert (tmp_path / "port.jsonl").read_text().count("\n") == 2
    assert "finished 3 steps (0 restarts)" in capsys.readouterr().out


def test_train_100m_resumes_bit_for_bit(tmp_path, monkeypatch, capsys):
    """55 steps, then ``main`` again to 60 on the same directory, equals an
    uninterrupted 60-step run bit for bit on the CPU: parameters, optimizer
    state and the resumed steps' losses."""
    port = load("train_100m", port=True)
    monkeypatch.setattr(port, "model_100m", lambda: _tiny(configs))
    whole = port.main(_train_argv(tmp_path, "whole", 60) + ["--device", "cpu"])
    first = port.main(_train_argv(tmp_path, "cut", 55) + ["--device", "cpu"])
    resumed = port.main(_train_argv(tmp_path, "cut", 60) + ["--device", "cpu"])
    assert first["stats"].steps_run == 55 and resumed["stats"].steps_run == 5
    assert sorted(resumed["losses"]) == list(range(55, 60))
    assert all(resumed["losses"][i] == whole["losses"][i] for i in range(55, 60))
    from repro_torch.training.optimizer import tree_leaves

    for tree in ("params", "opt"):
        for g, w in zip(tree_leaves(resumed[tree]), tree_leaves(whole[tree]), strict=True):
            assert torch.equal(g, w)
    assert whole["losses"][59] < whole["losses"][0]


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_raises_without_a_card(name, monkeypatch):
    """No card and no ``--device cpu``: the example raises, never falling
    back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load(name, port=True).main([])
