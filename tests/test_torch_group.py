"""Ranks in their own processes on the CPU: the port's collective over a
``torch.distributed`` gloo group (``comm.GroupComm``), one rank a process,
against the one-process ``Loopback`` executors, dense ``A @ B`` and the
JAX package.

Four processes are spawned once for the module (``run_ranks``) and run
every case; the cases at p = 3 and p = 2, and the expert-parallel MoE at
tp = 2, run in subgroups of them.  Each test reads its case's results:

- the seven models and summa2d at p = 4, monoC at p = 3 (the reference's
  ``case_api_odd_p``) and fine at p = 2: the dense C of every rank equals
  the one-process ``Loopback`` result bit for bit and ``A @ B`` within
  ``tests/test_kernels.py``'s 1e-4, and the ranks' ``items_moved`` sum to
  ``moved_items(plan)``;
- dense SUMMA (``spsumma``) on a 2 x 2 grid;
- ``compressed_psum_mean`` over 4 ranks for 8 rounds against the JAX
  function under ``shard_map`` on 4 forced host devices (a subprocess),
  and the three assertions of ``multidev_runner.case_compressed_psum``;
- the expert-parallel MoE forward on dbrx-132b's smoke config (fp32,
  B = 4, S = 32, as ``case_moe_ep``) at tp = 2 and 4, on JAX's
  ``init_params(cfg, key(0))`` carried across by ``params_from_reference``
  and cut by ``expert_shard``: against the one-rank forward, and against
  the JAX package's ``_moe_ep`` under a (1, tp) mesh on forced host
  devices (a subprocess), at capacity factor 8 (no pair dropped) and at
  the config's own 1.25 (pairs dropped);
- the expert-parallel decode: the same prefill, then ``DECODE_STEPS``
  greedy ``make_decode_step(cfg, ep_group)`` steps at tp = 2 and 4 and at
  both capacity factors (cap 16 and 3 at T = B = 4: with and without
  dropped pairs), against the one-process decode and against the JAX
  package's ``decode_step`` under the same (1, tp) mesh; the cache dict
  updated in place;
- a group of the wrong size and ranks holding different plans, each
  raising on every rank.

``test_ranks_on_the_card`` (marked ``gpu``) runs the products, the
compressed all-reduce and the expert-parallel forward in 4 processes on
one card, their tensors staged through the host for gloo.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.distributed.comm import GroupComm
from repro_torch.distributed.plan_ir import moved_items
from repro_torch.distributed.spgemm_exec import spsumma
from repro_torch.launch.ranks import run_ranks
from repro_torch.sparse.structure import random_structure

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = 4
MODELS = (*repro_torch.MODELS, "summa2d")
# (model, p): every model at p = 4, then the ones run in subgroups
CASES = [(m, P) for m in MODELS] + [("monoC", 3), ("fine", 2)]
TOL = dict(rtol=1e-4, atol=1e-4)  # against dense A @ B (tests/test_kernels.py)
MOE_ARCH = "dbrx-132b"
MOE_B, MOE_S = 4, 32
MOE_CFS = (8.0, 1.25)  # no pair dropped; the smoke config's own, which drops
DECODE_STEPS = 3
PSUM_ROUNDS = 8


def _operands():
    """The seeded instance of every product case (the reference's
    ``case_api_odd_p`` sizes) and its value vectors."""
    rng = np.random.default_rng(12)
    a_s = random_structure(20, 16, 0.2, rng)
    b_s = random_structure(16, 18, 0.2, rng)
    av = rng.standard_normal(a_s.nnz).astype(np.float32)
    bv = rng.standard_normal(b_s.nnz).astype(np.float32)
    return a_s, b_s, av, bv


def _dense(s, v):
    out = np.zeros(s.shape, np.float32)
    out[s.coo()] = v
    return out


def _moe_cfg(capacity_factor=8.0):
    from repro_torch.configs import get_smoke_config

    cfg = get_smoke_config(MOE_ARCH)
    return dataclasses.replace(cfg, dtype="float32",
                               moe=dataclasses.replace(cfg.moe, capacity_factor=capacity_factor))


def _moe_batch(cfg):
    rng = np.random.default_rng(0)
    return {"tokens": rng.integers(0, cfg.vocab, (MOE_B, MOE_S)).astype(np.int32)}


def _psum_inputs():
    return np.random.default_rng(0).standard_normal((P, 64, 32)).astype(np.float32)


# -- what every rank runs ------------------------------------------------------
def _product(handle, group, values):
    """One product through ``handle.compile(group=...)``: (dense C, items
    this rank moved)."""
    exe = handle.compile(device="cpu", group=group)
    exe.runtime.comm.reset()
    c = exe(*values)
    return c.numpy(), exe.runtime.comm.items_moved


def _raises(fn) -> str | None:
    """The message of the ``ValueError`` ``fn()`` raises (None if none)."""
    try:
        fn()
    except ValueError as exc:
        return str(exc)
    return None


def _serve_moe(params, cfg, ep_group=None):
    """Prefill ``_moe_batch`` then ``DECODE_STEPS`` greedy decode steps:
    (prefill logits, each step's logits, the tokens fed, whether every step
    returned the cache dict it was given with its tensors updated in
    place)."""
    from repro_torch.training import make_decode_step, make_prefill_step

    logits, cache = make_prefill_step(cfg, ep_group)(params, _moe_batch(cfg))
    decode = make_decode_step(cfg, ep_group)
    first, steps, tokens, in_place = logits.numpy(), [], [], True
    for _ in range(DECODE_STEPS):
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        held = {k: v.data_ptr() for k, v in cache.items() if k != "pos"}
        logits, out = decode(params, cache, tok)
        in_place &= out is cache and all(out[k].data_ptr() == p for k, p in held.items())
        steps.append(logits.numpy())
        tokens.append(tok.numpy())
    return first, np.stack(steps), np.stack(tokens), in_place


def _every_case(group, device, handles, values, moe_tree):
    import torch.distributed as dist

    from repro_torch.models import convert, forward
    from repro_torch.training.compression import compressed_psum_mean

    rank = dist.get_rank(group)
    # every rank makes every subgroup, in the same order
    sub = {3: dist.new_group([0, 1, 2]), 2: dist.new_group([0, 1])}
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    out = {}
    for model, p in CASES:
        if rank < p:
            out[(model, p)] = _product(handles[(model, p)], group if p == P else sub[p], values)
    a_s, b_s, av, bv = _operands()
    comm = GroupComm(group)
    c = spsumma(_dense(a_s, av), _dense(b_s, bv), (2, 2), device=device, comm=comm)
    out["spsumma"] = c.numpy(), comm.items_moved

    xs = _psum_inputs()
    err = torch.zeros(xs.shape[1:])
    means, errs = [], []
    for _ in range(PSUM_ROUNDS):
        mean, err = compressed_psum_mean(torch.from_numpy(xs[rank]), err, group)
        means.append(mean.numpy())
        errs.append(err.numpy())
    out["psum"] = np.stack(means), np.stack(errs)

    full = convert.params_from_reference(moe_tree, device=device)
    for tp, g in ((P, group), (2, pairs[rank // 2])):
        params = convert.expert_shard(full, dist.get_rank(g), tp)
        for cf in MOE_CFS:
            cfg = _moe_cfg(cf)
            logits, aux = forward(params, cfg, _moe_batch(cfg), ep_group=g)
            out[("moe", tp, cf)] = logits.numpy(), float(aux)
            out[("decode", tp, cf)] = _serve_moe(params, cfg, g)

    monoC = handles[("monoC", P)]
    out["wrong_size"] = _raises(lambda: handles[("fine", 2)].compile(device="cpu", group=group))
    other = handles[("fine", P)] if rank == P - 1 else monoC
    out["mismatch"] = _raises(lambda: other.compile(device="cpu", group=group))
    return out


def _fails(group, device):
    import torch.distributed as dist

    if dist.get_rank(group) == 1:
        raise ArithmeticError("rank 1 fails on purpose")
    return dist.get_rank(group)


# -- the module's one run of the ranks ------------------------------------------
@pytest.fixture(scope="module")
def plans():
    """Rank 0's role: the handles every rank compiles, planned once."""
    a_s, b_s, av, bv = _operands()
    return {(m, p): repro_torch.plan(a_s, b_s, p=p, model=m) for m, p in CASES}, (av, bv)


@pytest.fixture(scope="module")
def moe_tree():
    """JAX's ``init_params(cfg, key(0))`` for the MoE cases, as numpy
    arrays (the capacity factor does not enter the tree)."""
    import jax

    from repro.configs import get_smoke_config
    from repro.models import init_params

    cfg = get_smoke_config(MOE_ARCH)
    cfg = dataclasses.replace(cfg, dtype="float32")
    return jax.tree.map(np.asarray, init_params(cfg, jax.random.key(0)))


@pytest.fixture(scope="module")
def ranks(plans, moe_tree, tmp_path_factory):
    handles, values = plans
    results = run_ranks(_every_case, P, device="cpu",
                        workdir=tmp_path_factory.mktemp("ranks"),
                        args=(handles, values, moe_tree), timeout=600)
    return [r.result for r in results]


@pytest.mark.parametrize("model,p", CASES)
def test_ranks_in_processes_equal_loopback_and_dense(plans, ranks, model, p):
    handles, values = plans
    handle = handles[(model, p)]
    exe = handle.compile(device="cpu")
    exe.runtime.comm.reset()
    want = exe(*values).numpy()
    a_s, b_s, av, bv = _operands()
    np.testing.assert_allclose(want, _dense(a_s, av) @ _dense(b_s, bv), **TOL)
    items = []
    for rank in range(p):
        got, moved = ranks[rank][(model, p)]
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want), (rank, np.abs(got - want).max())
        items.append(moved)
    assert all((model, p) not in r for r in ranks[p:])
    assert sum(items) == moved_items(handle.execution_plan) == exe.runtime.comm.items_moved
    assert min(items) >= 0


def test_spsumma_on_a_2x2_grid(ranks):
    a_s, b_s, av, bv = _operands()
    a, b = _dense(a_s, av), _dense(b_s, bv)
    from repro_torch.distributed.comm import Loopback

    loop = Loopback(P)
    want = spsumma(a, b, (2, 2), device="cpu", comm=loop).numpy()
    np.testing.assert_allclose(want, a @ b, **TOL)
    for r in ranks:
        np.testing.assert_array_equal(r["spsumma"][0], want)
    assert sum(r["spsumma"][1] for r in ranks) == loop.items_moved > 0


_JAX_PSUM = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.compat import shard_map
from repro.training.compression import compressed_psum_mean
xs = np.load(sys.argv[1])
mesh = Mesh(np.array(jax.devices()[:4]), ("x",))
fn = jax.jit(shard_map(
    lambda x, e: tuple(o[None] for o in compressed_psum_mean(x[0], e[0], "x")),
    mesh=mesh, in_specs=(P("x"), P("x")), out_specs=(P("x"), P("x"))))
err = np.zeros_like(xs)
means, errs = [], []
for _ in range(int(sys.argv[3])):
    mean, err = fn(jnp.asarray(xs), jnp.asarray(err))
    err = np.asarray(err)
    means.append(np.asarray(mean))
    errs.append(err)
np.savez(sys.argv[2], means=np.stack(means), errs=np.stack(errs))
"""


@pytest.fixture(scope="module")
def jax_psum(tmp_path_factory):
    """The JAX function's rounds under ``shard_map`` on 4 forced host
    devices: means and errors, (rounds, rank, 64, 32)."""
    tmp = tmp_path_factory.mktemp("jax_psum")
    np.save(tmp / "xs.npy", _psum_inputs())
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, "-c", _JAX_PSUM, str(tmp / "xs.npy"), str(tmp / "out.npz"),
         str(PSUM_ROUNDS)],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    return np.load(tmp / "out.npz")


def test_compressed_psum_mean_equals_jax(ranks, jax_psum):
    for rank, r in enumerate(ranks):
        means, errs = r["psum"]
        np.testing.assert_allclose(means, jax_psum["means"][:, rank], rtol=0, atol=1e-6)
        np.testing.assert_allclose(errs, jax_psum["errs"][:, rank], rtol=0, atol=1e-6)


def test_compressed_psum_mean_meets_the_reference_case(ranks):
    from repro_torch.training.compression import compression_ratio

    xs = _psum_inputs()
    exact = xs.mean(axis=0)
    means = ranks[0]["psum"][0]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["psum"][0], means)  # one mean on every rank
    # single-shot error bounded by the max quantization scale
    scale = np.abs(xs).max() / 127.0
    assert np.abs(means[0] - exact).max() <= 4 * scale
    # error feedback: the running average converges below one-shot error
    avg = np.mean(means, axis=0)
    assert np.abs(avg - exact).max() < np.abs(means[0] - exact).max() + 1e-7
    # wire format really is int8-sized: compression ratio 2x vs bf16
    assert compression_ratio() == 2.0


def _one_rank(moe_tree, cf):
    """The port's one-process forward on the same tree: (logits, aux, pairs
    the MoE layers dropped for want of capacity)."""
    from repro_torch.models import convert, forward, layers

    dropped = []
    combine = layers._moe_dispatch_combine

    def counting(xt, fe, ft, fg, wi, wg, wo, n_experts, cap, act_dtype):
        pos = torch.arange(fe.numel()) - torch.searchsorted(fe, fe, side="left")
        dropped.append(int(((pos >= cap) & (fe < n_experts)).sum()))
        return combine(xt, fe, ft, fg, wi, wg, wo, n_experts, cap, act_dtype)

    cfg = _moe_cfg(cf)
    params = convert.params_from_reference(moe_tree, device="cpu")
    layers._moe_dispatch_combine = counting
    try:
        logits, aux = forward(params, cfg, _moe_batch(cfg))
    finally:
        layers._moe_dispatch_combine = combine
    return logits.numpy(), float(aux), sum(dropped)


@pytest.mark.parametrize("tp", [2, P])
def test_expert_parallel_moe_equals_one_rank(ranks, moe_tree, tp):
    cfg = _moe_cfg()
    assert cfg.moe.n_experts % tp == 0
    want, aux, dropped = _one_rank(moe_tree, 8.0)
    assert dropped == 0
    for r in ranks:
        got, got_aux = r[("moe", tp, 8.0)]
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
        assert abs(got_aux - aux) < 2e-4


@pytest.mark.parametrize("tp", [2, P])
def test_expert_parallel_moe_drops_the_pairs_one_rank_drops(ranks, moe_tree, tp):
    """At the smoke config's own capacity factor some expert is routed more
    pairs than its ``cap``: the EP ranks, each at the global ``cap`` with a
    stable sort, drop the same pairs as the one-process layer."""
    want, aux, dropped = _one_rank(moe_tree, MOE_CFS[1])
    assert dropped > 0
    assert not np.allclose(want, _one_rank(moe_tree, 8.0)[0], rtol=0, atol=2e-4)
    for r in ranks:
        got, got_aux = r[("moe", tp, MOE_CFS[1])]
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
        assert abs(got_aux - aux) < 2e-4


_JAX_EP = """
import dataclasses, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
from repro.configs import get_smoke_config
from repro.models import decode_step, forward, init_params
from repro.models.transformer import prefill_step
import repro.models.layers as layers
from repro.models.sharding import param_shardings
ep_calls = []
moe_ep = layers._moe_ep
layers._moe_ep = lambda *a: ep_calls.append(1) or moe_ep(*a)
base = dataclasses.replace(get_smoke_config(sys.argv[1]), dtype="float32")
tokens = np.load(sys.argv[2])
out = {}
for cf in (float(c) for c in sys.argv[4].split(",")):
    cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe, capacity_factor=cf))
    params = init_params(cfg, jax.random.key(0))
    for tp in (2, 4):
        mesh = jax.make_mesh((1, tp), ("data", "model"), devices=jax.devices()[:tp],
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
        with jax.set_mesh(mesh):
            psh = param_shardings(cfg, mesh)
            n = len(ep_calls)
            sharded = jax.device_put(params, psh)
            logits, aux = jax.jit(lambda p, b: forward(p, cfg, b))(sharded, {"tokens": tokens})
            assert len(ep_calls) > n, "the expert-parallel path did not run"
            last, cache = jax.jit(lambda p, b: prefill_step(p, cfg, b))(
                sharded, {"tokens": tokens})
            decode = jax.jit(lambda p, c, t: decode_step(p, cfg, c, t))
            steps, n = [], len(ep_calls)
            for _ in range(int(sys.argv[5])):
                tok = np.asarray(last.argmax(-1))[:, None].astype(np.int32)
                last, cache = decode(sharded, cache, tok)
                steps.append(np.asarray(last))
            assert len(ep_calls) > n, "the decode step did not run expert-parallel"
        out[f"logits_{tp}_{cf}"] = np.asarray(logits)
        out[f"aux_{tp}_{cf}"] = np.asarray(aux)
        out[f"decode_{tp}_{cf}"] = np.stack(steps)
np.savez(sys.argv[3], **out)
"""


@pytest.fixture(scope="module")
def jax_ep(tmp_path_factory):
    """The JAX package's expert-parallel forward, and prefill then greedy
    decode (``_moe_ep`` under a (1, tp) mesh, ``param_shardings``) on 4
    forced host devices: logits and aux, and each decode step's logits,
    for every (tp, capacity factor)."""
    tmp = tmp_path_factory.mktemp("jax_ep")
    np.save(tmp / "tokens.npy", _moe_batch(_moe_cfg())["tokens"])
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, "-c", _JAX_EP, MOE_ARCH, str(tmp / "tokens.npy"), str(tmp / "out.npz"),
         ",".join(str(cf) for cf in MOE_CFS), str(DECODE_STEPS)],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    return np.load(tmp / "out.npz")


@pytest.mark.parametrize("cf", MOE_CFS)
@pytest.mark.parametrize("tp", [2, P])
def test_expert_parallel_moe_equals_jax(ranks, jax_ep, tp, cf):
    want = jax_ep[f"logits_{tp}_{cf}"]
    for r in ranks:
        got, aux = r[("moe", tp, cf)]
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        assert abs(aux - float(jax_ep[f"aux_{tp}_{cf}"])) < 1e-4


def _one_rank_decode(moe_tree, cf):
    """The port's one-process prefill and decode on the same tree
    (``_serve_moe``), and the pairs its decode steps' MoE layers dropped."""
    from repro_torch.models import convert, layers

    dropped = []
    combine = layers._moe_dispatch_combine

    def counting(xt, fe, ft, fg, wi, wg, wo, n_experts, cap, act_dtype):
        if xt.shape[0] == MOE_B:  # a decode step's T = B tokens
            pos = torch.arange(fe.numel()) - torch.searchsorted(fe, fe, side="left")
            dropped.append(int(((pos >= cap) & (fe < n_experts)).sum()))
        return combine(xt, fe, ft, fg, wi, wg, wo, n_experts, cap, act_dtype)

    params = convert.params_from_reference(moe_tree, device="cpu")
    layers._moe_dispatch_combine = counting
    try:
        out = _serve_moe(params, _moe_cfg(cf))
    finally:
        layers._moe_dispatch_combine = combine
    return out, sum(dropped)


@pytest.mark.parametrize("cf", MOE_CFS)
@pytest.mark.parametrize("tp", [2, P])
def test_expert_parallel_decode_equals_one_rank(ranks, moe_tree, tp, cf):
    """At decode T = B = 4, so the global cap is 16 at capacity factor 8
    (nothing dropped) and 3 at 1.25, where the one-process step drops
    pairs: the EP ranks drop the same ones.  The cache is updated in
    place on every rank."""
    (first, steps, tokens, in_place), dropped = _one_rank_decode(moe_tree, cf)
    assert in_place and steps.shape == (DECODE_STEPS, MOE_B, _moe_cfg().vocab)
    assert (dropped > 0) == (cf == MOE_CFS[1]), dropped
    for r in ranks:
        got_first, got, got_tokens, got_in_place = r[("decode", tp, cf)]
        assert got_in_place
        np.testing.assert_allclose(got_first, first, rtol=0, atol=2e-4)
        np.testing.assert_array_equal(got_tokens, tokens)
        np.testing.assert_allclose(got, steps, rtol=0, atol=2e-4)


@pytest.mark.parametrize("cf", MOE_CFS)
@pytest.mark.parametrize("tp", [2, P])
def test_expert_parallel_decode_equals_jax(ranks, jax_ep, tp, cf):
    want = jax_ep[f"decode_{tp}_{cf}"]
    for r in ranks:
        got = r[("decode", tp, cf)][1]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_decode_over_sharded_experts_without_their_group_raises():
    from repro_torch.models import convert, init_params
    from repro_torch.training import make_decode_step, make_prefill_step

    cfg = _moe_cfg()
    full = init_params(cfg, 0, device="cpu")
    _, cache = make_prefill_step(cfg)(full, _moe_batch(cfg))
    params = convert.expert_shard(full, 1, 2)
    tok = torch.zeros((MOE_B, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="ep_group"):
        make_decode_step(cfg)(params, cache, tok)


def test_sharded_experts_without_their_group_raise():
    from repro_torch.models import convert, forward, init_params

    cfg = _moe_cfg()
    params = convert.expert_shard(init_params(cfg, 0, device="cpu"), 1, 2)
    assert params["layers"]["moe"]["wi"].shape[1] == cfg.moe.n_experts // 2
    with pytest.raises(ValueError, match="ep_group"):
        forward(params, cfg, _moe_batch(cfg))


@pytest.mark.parametrize("case,match", [
    ("wrong_size", "process group of 4"),
    ("mismatch", r"ranks \[3\] of the group hold another plan"),
])
def test_misuse_raises_on_every_rank(ranks, case, match):
    import re

    for r in ranks:
        assert r[case] is not None and re.search(match, r[case]), r[case]


def _card_case(group, device, handles, values):
    """On the card: every product over the group, the compressed all-reduce
    and the expert-parallel forward, their tensors staged through the host
    by ``GroupComm``."""
    import torch.distributed as dist

    from repro_torch.models import convert, forward, init_params
    from repro_torch.training.compression import compressed_psum_mean

    out = {}
    for model in MODELS:
        exe = handles[(model, P)].compile(device=device, group=group)
        exe.runtime.comm.reset()
        c = exe(*(torch.from_numpy(v).to(device) for v in values))
        assert c.device == device
        out[model] = c.cpu().numpy(), exe.runtime.comm.items_moved
    xs = torch.from_numpy(_psum_inputs()[dist.get_rank(group)]).to(device)
    mean, err = compressed_psum_mean(xs, torch.zeros_like(xs), group)
    out["psum"] = mean.cpu().numpy(), err.cpu().numpy()
    cfg = _moe_cfg()
    params = convert.expert_shard(init_params(cfg, 0, device=device), dist.get_rank(group), P)
    out["moe"] = forward(params, cfg, _moe_batch(cfg), ep_group=group)[0].cpu().numpy()
    return out


@pytest.mark.gpu
def test_ranks_on_the_card(plans, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.models import forward, init_params

    handles, values = plans
    card = torch.device("cuda", 0)
    results = run_ranks(_card_case, P, device=card, workdir=tmp_path, args=(handles, values),
                        timeout=600)
    for r in results:  # K1 (monoC, summa2d) and K3 (the experts) ran in every child
        assert r.launches["bsr_spgemm"]["scalar_runs"] > 0
        assert sum(r.launches["moe_gemm"].values()) > 0
    ranks = [r.result for r in results]
    for model in MODELS:
        exe = handles[(model, P)].compile(device=card)
        exe.runtime.comm.reset()
        want = exe(*(torch.from_numpy(v).to(card) for v in values)).cpu().numpy()
        for r in ranks:
            got = r[model][0]
            if model in ("monoC", "summa2d"):  # K1 sums in a fixed order
                np.testing.assert_array_equal(got, want)
            np.testing.assert_allclose(got, want, **TOL)
        assert sum(r[model][1] for r in ranks) == exe.runtime.comm.items_moved
    exact = _psum_inputs().mean(axis=0)
    scale = np.abs(_psum_inputs()).max() / 127.0
    for r in ranks:
        np.testing.assert_array_equal(r["psum"][0], ranks[0]["psum"][0])
        assert np.abs(r["psum"][0] - exact).max() <= scale / 2 + 1e-6
    cfg = _moe_cfg()
    want = forward(init_params(cfg, 0, device=card), cfg, _moe_batch(cfg))[0].cpu().numpy()
    for r in ranks:
        np.testing.assert_allclose(r["moe"], want, rtol=0, atol=2e-4)


def test_a_failing_rank_fails_the_call_with_its_traceback(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # a relative workdir meets all the same
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed") as info:
        run_ranks(_fails, 2, device="cpu", workdir="ranks", timeout=120)
    assert "ArithmeticError: rank 1 fails on purpose" in str(info.value)


def test_run_ranks_on_the_card_needs_one(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_ranks(_fails, 2, device="cuda", workdir=tmp_path)
