"""The LM serving steps sharded over a ``DeviceMesh``: 4 gloo processes on
the CPU (``launch.ranks.run_ranks``, one spawn per mesh, shared by the
tests of that mesh), each rank holding the ten smoke configs' parameters
distributed by ``param_shardings`` and its batch by ``batch_sharding``,
runs ``forward``, ``prefill_step`` and 4 greedy ``decode_step``s on
DTensors; the gathered results must equal the one-process port's (which
``test_torch_lm.py`` holds to JAX) in fp32 within its 1e-4; so do
internlm2's with each of the config's sharding knobs set.  With the
slots split (``kv_shard_mode`` "seq") in bf16, the slot shards' attention
combine is held to the one-process ``decode_attention``, and internlm2's
teacher-forced decode to the same mesh's decode with whole slots
("none"), bit for bit.

Under a mesh the reference's MoE layer dispatches each batch shard's
tokens at that shard's capacity (its ``_moe_ep`` under ``shard_map``), so
the one-process side runs each data shard's rows on their own, as the
sharded step does; the aux loss (global) is held to the one-process run
over the whole batch where the configs drop no pair ((1, 4): one data
shard).  Qwen3-MoE and DBRX at 'model' 2 and 4 must take the
expert-parallel path, once a MoE layer a step, on the mesh's 'model'
group, with one all-reduce each there.  On a (4, 1) mesh ('model' 1)
they take the reference's plain path: each rank dispatches only its own
batch shard's tokens (none gathered), and keeps the pairs the whole
batch's queue keeps at the global capacity, so the steps equal the
one-process port over the whole batch; so do they with the batch split
over (pod, data) = (2, 2)."""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.configs as configs
from repro_torch.launch.ranks import run_ranks
from repro_torch.models import forward, init_params
from repro_torch.training import make_decode_step, make_prefill_step

TOL = 1e-4
BF16_TOL = 2e-2  # chip_smoke.py's bf16 rule: |got - want| <= 2e-2 + 2e-2 |want|
ARCHS = configs.all_arch_ids()
MOE_ARCHS = [a for a in ARCHS if configs.get_smoke_config(a).moe is not None]
B, S, DECODE_STEPS = 2, 32, 4
# the config's sharding knobs, which act under a mesh and change no value
KNOBS = {
    "seq_shard": {"seq_shard_residual": True},
    "gather_weights": {"gather_weights": True},
    "kv_none": {"kv_shard_mode": "none"},
    # slots over 'model', which must not split the kv heads too: one kv head
    "kv_seq": {"kv_shard_mode": "seq", "n_kv_heads": 1},
}
CASES = [(arch, None) for arch in ARCHS] + [("internlm2-1.8b", knob) for knob in KNOBS]


def _cfg(arch, knob):
    cfg = configs.get_smoke_config(arch)
    return cfg if knob is None else dataclasses.replace(cfg, **KNOBS[knob])


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke sizes are paced by dispatch, not arithmetic: one intra-op
    thread, so the test leaves the host's cores to the other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(cfg, b=B):
    rng = np.random.default_rng(0)
    n_front = 8 if cfg.frontend == "vision" else 0
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, S - n_front)).astype(np.int32)}
    if n_front:
        batch["frontend_embeds"] = rng.standard_normal((b, n_front, cfg.d_model)).astype(
            np.float32)
    return batch


def _bf16_cfg():
    """internlm2 with its cache's slots split over 'model', in bf16."""
    return dataclasses.replace(_cfg("internlm2-1.8b", "kv_seq"), dtype="bfloat16")


def _attention_inputs():
    """One bf16 decode step's (q, k cache, v cache, cache_pos, pos): B x 8
    query heads of 64 over 32 slots of one kv head, the last 7 empty."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(B, 1, 8, 64, generator=g).bfloat16()
    k, v = (torch.randn(B, 32, 1, 64, generator=g).bfloat16() for _ in range(2))
    cache_pos = torch.arange(32)
    cache_pos[25:] = -1
    return q, k, v, cache_pos, torch.tensor(24)


def _forced_tokens(cfg):
    """The decode steps' tokens, the same on both sides (no greedy pick,
    which bf16 differences could turn)."""
    rng = np.random.default_rng(1)
    return [torch.as_tensor(rng.integers(0, cfg.vocab, (B, 1))) for _ in range(DECODE_STEPS)]


def _bf16_steps(cfg, params, batch, tokens, put=lambda t: t):
    """The prefill's and the teacher-forced decode steps' logits, fp32."""
    logits, cache = make_prefill_step(cfg)(params, batch)
    out = [_whole(logits.float())]
    decode = make_decode_step(cfg)
    for tok in tokens:
        logits, cache = decode(params, cache, put(tok))
        out.append(_whole(logits.float()))
    return out


def _whole(t) -> np.ndarray:
    from torch.distributed.tensor import DTensor

    return (t.full_tensor() if isinstance(t, DTensor) else t).detach().numpy()


def _serve_rank(group, device, shape):
    """One rank: the ten configs on a ``shape`` (data, model) mesh."""
    import torch.distributed as dist

    import repro_torch.models.layers as L
    from repro_torch.launch.dryrun import Census
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import sharding as sh

    mesh = make_mesh(shape, ("data", "model"), "cpu")
    ep_calls = []
    real_ep = L._moe_ep

    def watched(xt, gate_idx, gate_vals, params, cfg, group):
        ep_calls.append((dist.get_world_size(group), dist.get_process_group_ranks(group)))
        return real_ep(xt, gate_idx, gate_vals, params, cfg, group)

    L._moe_ep = watched
    out = {}
    for arch, knob in CASES:
        cfg = _cfg(arch, knob)
        params = sh.distribute_params(init_params(cfg, 0, device="cpu"), mesh,
                                      sh.param_shardings(cfg, mesh))
        batch = {k: sh.distribute(torch.as_tensor(v), sh.batch_sharding(mesh, B, v.ndim))
                 for k, v in _batch(cfg).items()}
        ep_calls.clear()
        census = Census()
        with sh.set_mesh(mesh):
            with census:
                logits, aux = forward(params, cfg, batch, remat=False)
            rec = {"forward": _whole(logits), "aux": _whole(aux),
                   "forward_ep": list(ep_calls), "census": census.record()["collectives"]}
            logits, cache = make_prefill_step(cfg)(params, batch)
            rec["prefill"] = _whole(logits)
            rec["decode"] = []
            decode = make_decode_step(cfg)
            for _ in range(DECODE_STEPS):
                tok = torch.as_tensor(_whole(logits)).argmax(-1)[:, None]
                tok = sh.distribute(tok, sh.batch_sharding(mesh, B, 2))
                logits, cache = decode(params, cache, tok)
                rec["decode"].append(_whole(logits))
            rec["cache"] = {k: _whole(v) for k, v in cache.items()}
            rec["cache_placements"] = {k: str(getattr(v, "placements", None))
                                       for k, v in cache.items()}
        out[(arch, knob)] = rec
    out["model_group"] = dist.get_process_group_ranks(mesh.get_group("model"))

    import repro_torch.models.transformer as T

    cfg = _bf16_cfg()
    q, k, v, cache_pos, pos = _attention_inputs()
    slots = sh.Sharding(mesh, ("data", "model", None, None))
    rows = sh.Sharding(mesh, ("data", None, None, None))
    whole = lambda t: sh.distribute(t, sh.Sharding(mesh, (None,) * t.ndim))
    o = T._split_slots_attention(sh.distribute(q, rows), sh.distribute(k, slots),
                                 sh.distribute(v, slots), whole(cache_pos), whole(pos), cfg)
    out["kv_seq_bf16_attention"] = (_whole(o.float()), o.dtype)
    params = sh.distribute_params(init_params(cfg, 0, device="cpu"), mesh,
                                  sh.param_shardings(cfg, mesh))
    batch = {k: sh.distribute(torch.as_tensor(v), sh.batch_sharding(mesh, B, v.ndim))
             for k, v in _batch(cfg).items()}
    for mode in ("seq", "none"):
        out[f"kv_{mode}_bf16_steps"] = _bf16_steps(
            dataclasses.replace(cfg, kv_shard_mode=mode), params, batch, _forced_tokens(cfg),
            put=lambda t: sh.distribute(t, sh.batch_sharding(mesh, B, 2)))
    return out


@pytest.fixture(scope="module", params=[(2, 2), (1, 4)], ids=["2x2", "1x4"])
def served(request, tmp_path_factory):
    shape = request.param
    results = run_ranks(_serve_rank, 4, device="cpu", workdir=tmp_path_factory.mktemp("pg"),
                        args=(shape,), timeout=600)
    return shape, results


def _one_process(cfg, shape, b=B):
    """The one-process port, each of ``shape[0]`` data shards' rows on
    their own."""
    params = init_params(cfg, 0, device="cpu")
    batch = _batch(cfg, b)
    shards = [slice(i * b // shape[0], (i + 1) * b // shape[0]) for i in range(shape[0])]
    want = {"forward": [], "prefill": [], "decode": [], "cache": []}
    for rows in shards:
        b = {k: v[rows] for k, v in batch.items()}
        want["forward"].append(forward(params, cfg, b, remat=False)[0].detach().numpy())
        logits, cache = make_prefill_step(cfg)(params, b)
        want["prefill"].append(logits.numpy())
        steps = []
        decode = make_decode_step(cfg)
        for _ in range(DECODE_STEPS):
            logits, cache = decode(params, cache, logits.argmax(-1)[:, None])
            steps.append(logits.numpy())
        want["decode"].append(steps)
        want["cache"].append({k: v.numpy() for k, v in cache.items()})
    cat = lambda xs: np.concatenate(xs, axis=0)
    return {
        "forward": cat(want["forward"]), "prefill": cat(want["prefill"]),
        "decode": [cat([d[i] for d in want["decode"]]) for i in range(DECODE_STEPS)],
        "cache": want["cache"], "aux": float(forward(params, cfg, batch, remat=False)[1]),
    }


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=what)


@pytest.mark.parametrize("arch,knob", CASES, ids=[a + (f"-{k}" if k else "") for a, k in CASES])
def test_sharded_serving_equals_one_process(served, arch, knob):
    shape, results = served
    cfg = _cfg(arch, knob)
    want = _one_process(cfg, shape)
    for r in results:  # every rank gathers the same tensors
        got = r.result[(arch, knob)]
        _close(got["forward"], want["forward"], f"{arch} forward, rank {r.rank}")
        _close(got["prefill"], want["prefill"], f"{arch} prefill, rank {r.rank}")
        for i in range(DECODE_STEPS):
            _close(got["decode"][i], want["decode"][i], f"{arch} decode {i}, rank {r.rank}")
    got = results[0].result[(arch, knob)]
    for key, value in got["cache"].items():
        if key == "pos":
            assert int(value) == S + DECODE_STEPS
            continue
        if key == "cache_pos":  # (layers, slots): every shard's the same
            _close(value, want["cache"][0][key], f"{arch} cache {key}")
        else:  # (layers, batch, ...)
            _close(value, np.concatenate([c[key] for c in want["cache"]], axis=1),
                   f"{arch} cache {key}")
    if cfg.moe is None or shape[0] == 1:  # the same pairs kept as over the whole batch
        _close(got["aux"], want["aux"], f"{arch} aux")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_takes_the_expert_parallel_path_on_the_model_group(served, arch):
    shape, results = served
    cfg = configs.get_smoke_config(arch)
    for r in results:
        rec = r.result[(arch, None)]
        model_group = r.result["model_group"]
        assert len(model_group) == shape[1]
        assert rec["forward_ep"] == [(shape[1], model_group)] * cfg.n_layers
    # the group's all-reduce (the combine) is counted beside DTensor's own
    assert results[0].result[(arch, None)]["census"]["all-reduce"]["count"] >= cfg.n_layers


def test_the_cache_lies_by_kv_shard_mode(served):
    shape, results = served
    placements = results[0].result[("internlm2-1.8b", None)]["cache_placements"]
    # (layers, batch, slots, kv heads, head dim): batch over data, kv heads over model
    want = {(2, 2): "(Shard(dim=1), Shard(dim=3))", (1, 4): "(Shard(dim=1), Replicate())"}[shape]
    assert placements["k"] == placements["v"] == want


def test_kv_seq_bf16_attention_sums_the_slot_shards_in_fp32(served):
    """Each slot shard's weighted values are summed across the shards in
    fp32 and rounded once, as ``decode_attention``'s one product rounds
    once: the bf16 result is within one bf16 step (2^-8 of its size) of the
    one-process one, where bf16 partial sums added in bf16 are not."""
    from repro_torch.models.layers import decode_attention

    want = decode_attention(*_attention_inputs()).float().numpy()
    for r in served[1]:
        got, dtype = r.result["kv_seq_bf16_attention"]
        assert dtype == torch.bfloat16
        assert np.all(np.abs(got - want) <= 2.0 ** -8 * np.abs(want)), \
            f"rank {r.rank}: max |diff| {np.abs(got - want).max()}"


def test_kv_seq_bf16_decode_equals_the_whole_slots_decode(served):
    """The slot split and its fp32 combine change no bf16 logit: internlm2's
    prefill and teacher-forced decode steps with the slots split over
    'model' equal the same mesh's with whole slots bit for bit.  (Either
    differs from the one-process bf16 steps by as much as those differ
    from fp32, up to 0.06 at logits of 3.6: the tensor-parallel products'
    bf16 partial sums, in every layer.)"""
    for r in served[1]:
        seq, whole = r.result["kv_seq_bf16_steps"], r.result["kv_none_bf16_steps"]
        assert len(seq) == DECODE_STEPS + 1
        assert [np.array_equal(a, b) for a, b in zip(seq, whole)] == [True] * len(seq)


FALLBACK_B = 4
FALLBACK_MESHES = {"4x1": ((4, 1), ("data", "model")),
                   "2x2x1": ((2, 2, 1), ("pod", "data", "model"))}


def _fallback_rank(group, device):
    """One rank of a (4, 1) (data, model) mesh and of a (2, 2, 1) (pod,
    data, model) one: the MoE configs' forward, prefill and greedy decode
    steps, and the tokens each MoE dispatch was given."""
    import repro_torch.models.layers as L
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import sharding as sh

    rows, real = [], L._moe_dispatch_combine

    def watched(xt, *args, **kwargs):
        rows.append(xt.shape[0])
        return real(xt, *args, **kwargs)

    def steps(cfg, mesh):
        params = sh.distribute_params(init_params(cfg, 0, device="cpu"), mesh,
                                      sh.param_shardings(cfg, mesh))
        put = lambda t: sh.distribute(torch.as_tensor(t),
                                      sh.batch_sharding(mesh, FALLBACK_B, t.ndim))
        batch = {k: put(v) for k, v in _batch(cfg, FALLBACK_B).items()}
        rows.clear()
        with sh.set_mesh(mesh):
            logits, aux = forward(params, cfg, batch, remat=False)
        rec = {"forward": _whole(logits), "aux": _whole(aux), "rows": list(rows)}
        logits, cache = make_prefill_step(cfg)(params, batch)
        rec["prefill"], rec["decode"] = _whole(logits), []
        decode = make_decode_step(cfg)
        for _ in range(DECODE_STEPS):
            tok = put(torch.as_tensor(_whole(logits)).argmax(-1)[:, None])
            logits, cache = decode(params, cache, tok)
            rec["decode"].append(_whole(logits))
        return rec

    L._moe_dispatch_combine = watched
    meshes = {name: make_mesh(shape, axes, "cpu") for name, (shape, axes) in FALLBACK_MESHES.items()}
    return {(arch, name): steps(configs.get_smoke_config(arch), mesh)
            for arch in MOE_ARCHS for name, mesh in meshes.items()}


@pytest.fixture(scope="module")
def fallback(tmp_path_factory):
    return run_ranks(_fallback_rank, 4, device="cpu", workdir=tmp_path_factory.mktemp("pg"),
                     timeout=600)


@pytest.mark.parametrize("mesh", FALLBACK_MESHES)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_on_a_model_axis_of_one_keeps_its_tokens_split(fallback, arch, mesh):
    cfg = configs.get_smoke_config(arch)
    want = _one_process(cfg, (1, 1), FALLBACK_B)  # the whole batch's queue
    for r in fallback:
        got = r.result[(arch, mesh)]
        assert got["rows"] == [FALLBACK_B * S // 4] * cfg.n_layers  # each rank's own tokens
        _close(got["forward"], want["forward"], f"{arch} forward, rank {r.rank}")
        _close(got["aux"], want["aux"], f"{arch} aux, rank {r.rank}")
        _close(got["prefill"], want["prefill"], f"{arch} prefill, rank {r.rank}")
        for i in range(DECODE_STEPS):
            _close(got["decode"][i], want["decode"][i], f"{arch} decode {i}, rank {r.rank}")
