"""The port's sharding rules (``repro_torch.models.sharding``) against the
JAX package's (``repro.models.sharding``), exactly: every case of
``test_sharding_rules.py``; ``spec_for``, ``_fit_spec``, ``serve_overlay``,
``param_logical_axes``, ``param_shardings`` (with and without ``serve``),
``batch_sharding`` and the dry run's cache axes, spec for spec and leaf for
leaf, on meshes of (1, 1), (2, 2), (16, 16) and (2, 16, 16) devices (the
reference on ``jax.sharding.AbstractMesh``, the port on a mesh of names
and sizes); then every leaf's DTensor local shape on the production
meshes, over a ``fake`` process group of 256 and of 512 ranks in this
process (started and destroyed by a fixture), against the reference's
``NamedSharding.shard_shape``, for the ten architectures' parameters, a
batch and a decode cache."""
import os

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as P

import repro.configs as jax_configs
import repro.models.sharding as jsh
import repro.models.transformer as jax_tf
import repro_torch.configs as configs
import repro_torch.models.sharding as sh
from repro_torch.configs.shapes import cache_specs, input_specs
from repro_torch.models import init_params

ARCHS = configs.all_arch_ids()
MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke sizes are paced by dispatch, not arithmetic: one intra-op
    thread, so the test leaves the host's cores to the other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class Mesh:
    """The port's view of a mesh: names and sizes (``sharding`` needs no more)."""

    def __init__(self, sizes, names):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, sizes))


def _mk(**sizes):
    return Mesh(tuple(sizes.values()), tuple(sizes))


def both(name):
    sizes, names = MESHES[name]
    return Mesh(sizes, names), AbstractMesh(sizes, names)


def jspec(spec) -> tuple:
    return tuple(spec)


def leaves(tree, prefix=""):
    """(path, leaf) pairs of a dict tree, by sorted key."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _reference_cache_axes(cfg):
    """The reference dry run's ``_cache_logical_axes``; its module sets
    ``XLA_FLAGS`` on import, which is put back."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import _cache_logical_axes
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return _cache_logical_axes(cfg)


# --- the cases of test_sharding_rules.py ------------------------------------
def test_fit_spec_drops_nondivisible_axes():
    mesh = _mk(data=16, model=16)
    # 4 KV heads cannot shard over 16-way model
    assert sh._fit_spec((None, "model", None), (64, 4, 128), mesh) == (None, None, None)
    # 64 heads can
    assert sh._fit_spec((None, "model", None), (64, 64, 128), mesh) == (None, "model", None)
    # vocab 32001 not divisible -> replicate
    assert sh._fit_spec(("model",), (32001,), mesh) == (None,)
    # tuple axes: keep only the prefix that divides
    assert sh._fit_spec((("pod", "data"),), (2,), _mk(pod=2, data=16)) == ("pod",)


def test_batch_sharding_divisibility():
    mesh = _mk(pod=2, data=16, model=16)
    assert sh._fit_spec((("pod", "data"),), (256,), mesh) == (("pod", "data"),)
    assert sh._fit_spec((("pod", "data"),), (1,), mesh) == (None,)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shardings_tree_matches_params(arch):
    cfg = configs.get_config(arch)
    got = sh.param_shardings(cfg, _mk(data=1, model=1))
    want = init_params(cfg, device="meta")
    assert [p for p, _ in leaves(got)] == [p for p, _ in leaves(want)]


def test_serve_overlay_drops_fsdp_axis():
    cfg = configs.get_config("internlm2-1.8b")
    axes = sh.param_logical_axes(cfg)
    served = sh.serve_overlay(axes)
    assert axes["embed"]["tokens"] == ("vocab", "embed_fsdp")
    assert served["embed"]["tokens"] == ("vocab", None)
    assert served["layers"]["attn"]["wq"][1] is None  # embed_fsdp dropped
    assert served["layers"]["attn"]["wq"][2] == "heads"  # TP kept


# --- against the reference ---------------------------------------------------
def test_rule_table_is_the_reference():
    assert sh.LOGICAL_RULES == jsh.LOGICAL_RULES


@pytest.mark.parametrize("mesh", list(MESHES))
def test_spec_for_and_fit_spec_match_the_reference(mesh):
    tm, jm = both(mesh)
    names = [None] + sorted(jsh.LOGICAL_RULES) + ["not_a_rule"]
    rng = np.random.default_rng(0)
    for _ in range(200):
        axes = tuple(rng.choice(len(names), size=rng.integers(1, 5)))
        logical = tuple(names[i] for i in axes)
        spec = sh.spec_for(*logical, mesh=tm)
        assert spec == jspec(jsh.spec_for(*logical, mesh=jm)), logical
        shape = tuple(int(d) for d in rng.choice([1, 2, 3, 4, 6, 16, 32, 48, 256, 32001],
                                                 size=len(logical)))
        assert sh._fit_spec(spec, shape, tm) == jspec(jsh._fit_spec(P(*spec), shape, jm)), (
            logical, shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_logical_axes_and_overlay_match_the_reference(arch):
    tcfg, jcfg = configs.get_config(arch), jax_configs.get_config(arch)
    axes, jaxes = sh.param_logical_axes(tcfg), jsh.param_logical_axes(jcfg)
    assert axes == jaxes
    assert sh.serve_overlay(axes) == jsh.serve_overlay(jaxes)
    assert sh.cache_logical_axes(tcfg) == _reference_cache_axes(jcfg)


@pytest.mark.parametrize("serve", [False, True], ids=["train", "serve"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_shardings_match_the_reference(arch, serve):
    """Every leaf's spec, and its shard shape, on each mesh."""
    tcfg, jcfg = configs.get_config(arch), jax_configs.get_config(arch)
    shapes = dict(leaves(init_params(tcfg, device="meta")))
    for mesh in MESHES:
        tm, jm = both(mesh)
        got = dict(leaves(sh.param_shardings(tcfg, tm, serve=serve)))
        want = dict(leaves(jsh.param_shardings(jcfg, jm, serve=serve)))
        assert sorted(got) == sorted(want)
        for path, s in got.items():
            shape = tuple(shapes[path].shape)
            assert s.spec == jspec(want[path].spec), (mesh, path)
            assert s.shard_shape(shape) == tuple(want[path].shard_shape(shape)), (mesh, path)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_sharding_matches_the_reference(mesh):
    tm, jm = both(mesh)
    for batch in (1, 2, 3, 8, 16, 32, 64, 128, 256, 512):
        for ndim in (1, 2, 3):
            got = sh.batch_sharding(tm, batch, ndim).spec
            assert got == jspec(jsh.batch_sharding(jm, batch, ndim).spec), (batch, ndim)


def test_placements_follow_the_spec_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    mesh = _mk(pod=2, data=16, model=16)
    assert sh.placements_for(mesh, (("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert sh.placements_for(mesh, (None, "data")) == (Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError):
        sh.placements_for(mesh, (("data", "pod"),))  # DTensor splits in mesh order only
    with pytest.raises(ValueError):
        sh.placements_for(mesh, ("model", "model"))


def test_constrain_is_a_no_op_without_a_mesh_or_on_a_plain_tensor():
    x = torch.ones(4, 8)
    assert sh.constrain(x, "batch", "embed") is x
    with sh.set_mesh(_mk(data=2, model=2)):
        assert sh.get_mesh() is not None
        assert sh.constrain(x, "batch", "embed") is x
    assert sh.get_mesh() is None


# --- local shapes over a fake group -----------------------------------------
@pytest.fixture(scope="module", params=["16x16", "2x16x16"])
def fake_mesh(request):
    """The production mesh over a ``fake`` group of its size (this process
    rank 0), and the reference's abstract mesh; the group is destroyed."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_production_mesh

    sizes, names = MESHES[request.param]
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=int(np.prod(sizes)))
    try:
        yield make_production_mesh(multi_pod=len(sizes) == 3, device_type="cpu"), \
            AbstractMesh(sizes, names)
    finally:
        dist.destroy_process_group()


def _local_shapes(tree, shardings):
    """The local shape of every leaf of ``tree`` (meta tensors) distributed
    by ``shardings``, on fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    out = {}
    with FakeTensorMode():
        for path, t in leaves(tree):
            s = dict(leaves(shardings))[path]
            d = sh.distribute(torch.zeros(t.shape, dtype=t.dtype), s)
            out[path] = tuple(d.to_local().shape)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_local_shapes_match_the_reference_shard_shapes(fake_mesh, arch):
    mesh, jm = fake_mesh
    tcfg, jcfg = configs.get_config(arch), jax_configs.get_config(arch)
    params = init_params(tcfg, device="meta")
    jshapes = dict(leaves(jax.eval_shape(lambda: jax_tf.init_params(jcfg, jax.random.key(0)))))
    for serve in (False, True):
        got = _local_shapes(params, sh.param_shardings(tcfg, mesh, serve=serve))
        want = dict(leaves(jsh.param_shardings(jcfg, jm, serve=serve)))
        for path, shape in got.items():
            assert shape == tuple(want[path].shard_shape(jshapes[path].shape)), (serve, path)
    # a batch and a decode cache, as the dry run distributes them
    for shape_name in ("train_4k", "decode_32k"):
        batch = input_specs(tcfg, shape_name)
        for k, t in batch.items():
            s = sh.batch_sharding(mesh, t.shape[0], t.ndim)
            local = _local_shapes({k: t}, {k: s})[f"/{k}"]
            js = jsh.batch_sharding(jm, t.shape[0], t.ndim)
            assert local == tuple(js.shard_shape(tuple(t.shape))), (shape_name, k)
    cache = cache_specs(tcfg, "decode_32k")
    got = _local_shapes(cache, sh.fit_sharding_tree(cache, sh.cache_logical_axes(tcfg), mesh))
    jaxes = _reference_cache_axes(jcfg)
    for path, shape in got.items():
        key = path[1:]
        spec = jsh._fit_spec(jsh.spec_for(*jaxes[key], mesh=jm), tuple(cache[key].shape), jm)
        assert shape == tuple(NamedSharding(jm, spec).shard_shape(tuple(cache[key].shape))), key
