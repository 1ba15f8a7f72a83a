"""``repro_torch.launch.mesh`` in this process: ``make_host_mesh`` starts a
one-rank gloo group when there is none (the fixture destroys it), a model
axis that does not divide the ranks raises, a card mesh without a card
raises; and on that (1, 1) mesh the ten smoke configs' prefill and 4
greedy decode steps on DTensors equal the unsharded steps bit for bit, in
fp32 (and in bf16 for a dense, a MoE and a hybrid config; phase 16 (b) of ``chip_smoke.py`` holds Qwen3-MoE at its
published width so on the card)."""
import dataclasses

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

import repro_torch.configs as configs
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.models import init_params
from repro_torch.models import sharding as sh
from repro_torch.training import make_decode_step, make_prefill_step
from repro_torch.training.optimizer import tree_leaves


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke sizes are paced by dispatch, not arithmetic: one intra-op
    thread, so the test leaves the host's cores to the other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def mesh():
    assert not dist.is_initialized()
    try:
        yield make_host_mesh(model=1, device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_host_mesh_is_one_rank_of_data_and_model(mesh):
    assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
    with pytest.raises(ValueError, match="does not divide"):
        make_host_mesh(model=2, device_type="cpu")


def test_a_card_mesh_needs_a_card(mesh):
    if torch.cuda.is_available():
        pytest.skip("a card is here")  # the check is for hosts without one
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh((1, 1), ("data", "model"))


def _steps(prefill, decode, params, batch, steps=4):
    whole = lambda t: t.full_tensor() if isinstance(t, DTensor) else t
    logits, cache = prefill(params, batch)
    out = [whole(logits)]
    for _ in range(steps):
        logits, cache = decode(params, cache, logits.argmax(-1)[:, None])
        out.append(whole(logits))
    return out


CASES = [(arch, "float32") for arch in configs.all_arch_ids()] + [
    (arch, "bfloat16") for arch in ("internlm2-1.8b", "qwen3-moe-235b-a22b", "hymba-1.5b")]


@pytest.mark.parametrize("arch,dtype", CASES)
def test_one_rank_mesh_serves_bit_for_bit(mesh, arch, dtype):
    cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype=dtype)
    params = init_params(cfg, 0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 32), generator=gen)}
    if cfg.frontend == "vision":
        batch["frontend_embeds"] = torch.randn(2, 8, cfg.d_model, generator=gen).to(
            getattr(torch, dtype))
    want = _steps(make_prefill_step(cfg), make_decode_step(cfg), params, batch)
    dparams = sh.distribute_params(params, mesh, sh.param_shardings(cfg, mesh))
    assert all(isinstance(t, DTensor) for t in tree_leaves(dparams))
    dbatch = {k: sh.distribute(v, sh.batch_sharding(mesh, 2, v.ndim)) for k, v in batch.items()}
    got = _steps(make_prefill_step(cfg), make_decode_step(cfg),
                 dparams, dbatch)
    assert [torch.equal(g, w) for g, w in zip(got, want)] == [True] * len(want)
