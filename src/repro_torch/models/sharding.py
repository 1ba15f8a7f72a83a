"""Sharding rules (the port of ``repro.models.sharding``): logical parameter
and activation axes -> mesh axes -> DTensor placements.

Megatron-style TP on the ``model`` axis, FSDP-style parameter/optimizer
sharding on the ``data`` axis, pure DP on the ``pod`` axis (multi-pod).
Experts (MoE) ride the ``model`` axis (expert parallelism).

The rule tables and the spec functions are the reference's.  A spec is a
tuple with one entry per tensor dim: a mesh-axis name, a tuple of names
(the dim split over each, major to minor), or ``None`` (replicated), as a
``PartitionSpec`` is.  ``placements_for`` turns a spec into DTensor
placements on a ``torch.distributed.device_mesh.DeviceMesh`` (GSPMD's
``NamedSharding`` becomes ``Shard(d)`` / ``Replicate()`` per mesh dim), and
``Sharding`` pairs the two.  A mesh here is a ``DeviceMesh`` with
``mesh_dim_names``, or any object with ``axis_names`` and a name-keyed
``shape`` (the rules need nothing else).

``constrain`` is the reference's ``with_sharding_constraint`` by logical
axes: under the ambient mesh (``set_mesh``), a DTensor is redistributed to
the fitted placements; a plain tensor, or any tensor with no mesh set, is
returned as it is.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

# logical axis name -> mesh axis (None = replicated)
LOGICAL_RULES: dict[str, str | tuple[str, ...] | None] = {
    "batch": ("pod", "data"),
    "seq": None,
    "seq_shard": "model",  # sequence-parallel regions (MoE entry)
    "embed": None,  # activations' feature axis
    "embed_fsdp": "data",  # weights' feature axis (FSDP)
    "heads": "model",
    "kv_heads": "model",
    "kv_seq": "model",  # sequence-sharded KV cache (distributed flash-decode)
    "head_dim": None,
    "ff": "model",
    "experts": "model",
    "expert_ff": None,
    "vocab": "model",
    "layers": None,
    "ssm_inner": "model",
    "ssm_state": None,
    "conv": None,
}

Spec = tuple  # of str | tuple[str, ...] | None, one entry per tensor dim


def axis_names(mesh) -> tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_size(mesh, name: str) -> int:
    """The size of mesh axis ``name``."""
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return mesh.size(mesh.mesh_dim_names.index(name))
    return mesh.shape[name]


def _is_axes(x) -> bool:
    """A logical-axes leaf: a tuple of names and ``None``s."""
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def map_axes(fn, axes_tree, *rest):
    """``fn`` over the logical-axes leaves of ``axes_tree`` and the matching
    leaves of the ``rest`` trees (nested dicts)."""
    if _is_axes(axes_tree):
        return fn(axes_tree, *rest)
    return {k: map_axes(fn, v, *(r[k] for r in rest)) for k, v in axes_tree.items()}


def spec_for(*logical_axes: str | None, mesh) -> Spec:
    """Translate logical axes to a spec valid for ``mesh`` (axes the mesh
    lacks — e.g. 'pod' on the single-pod mesh — are dropped)."""
    names = axis_names(mesh)
    out = []
    for ax in logical_axes:
        phys = None if ax is None else LOGICAL_RULES.get(ax, None)
        if phys is None:
            out.append(None)
        elif isinstance(phys, tuple):
            present = tuple(a for a in phys if a in names)
            out.append(present if len(present) > 1 else (present[0] if present else None))
        else:
            out.append(phys if phys in names else None)
    return tuple(out)


def _fit_spec(spec: Spec, shape: tuple[int, ...], mesh) -> Spec:
    """Drop mesh axes that do not divide the corresponding dim (e.g. 4 KV
    heads on a 16-way model axis, vocab 32001): replicate instead."""
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if ax is None:
            out.append(None)
            continue
        kept: list[str] = []
        size = 1
        for a in ax if isinstance(ax, tuple) else (ax,):
            if dim % (size * axis_size(mesh, a)) == 0:
                kept.append(a)
                size *= axis_size(mesh, a)
        out.append(tuple(kept) if len(kept) > 1 else (kept[0] if kept else None))
    return tuple(out)


def placements_for(mesh, spec: Spec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dim, the
    ``Shard(d)`` of the tensor dim whose entry names it, else
    ``Replicate()``.  A tuple entry ``("pod", "data")`` on dim d shards d
    over both mesh dims; DTensor splits a dim over its mesh dims in mesh
    order, so the tuple must list them in that order (JAX's major to
    minor), or this raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    by_axis: dict[str, int] = {}
    for d, ax in enumerate(spec):
        axes = ax if isinstance(ax, tuple) else (() if ax is None else (ax,))
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"spec entry {ax} is not in the mesh's axis order {names}")
        for a in axes:
            if a in by_axis:
                raise ValueError(f"mesh axis {a!r} shards two dims of spec {spec}")
            by_axis[a] = d
    return tuple(Shard(by_axis[n]) if n in by_axis else Replicate() for n in names)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec on a mesh (GSPMD's ``NamedSharding``), with its DTensor
    placements."""

    mesh: object
    spec: Spec

    @property
    def placements(self) -> tuple:
        return placements_for(self.mesh, self.spec)

    def shard_shape(self, shape) -> tuple[int, ...]:
        """The shape of one device's shard of a ``shape`` tensor."""
        out = list(shape)
        for d, ax in enumerate(self.spec):
            for a in ax if isinstance(ax, tuple) else (() if ax is None else (ax,)):
                out[d] //= axis_size(self.mesh, a)
        return tuple(out)


# ---------------------------------------------------------------------------
# parameter logical-axis trees (mirror the params tree structure)
# ---------------------------------------------------------------------------
def serve_overlay(axes_tree):
    """Serving shardings: drop the FSDP ('data') axis from weights — decode
    steps must not all-gather parameters every token.  Weights end up
    TP-sharded over 'model' and replicated over 'data'/'pod'."""
    return map_axes(
        lambda ax: tuple(None if a == "embed_fsdp" else a for a in ax), axes_tree
    )


def param_logical_axes(cfg) -> dict:
    """Logical axes per parameter; structure mirrors ``init_params``."""
    L = ("layers",)
    axes: dict = {
        "embed": {"tokens": ("vocab", "embed_fsdp")},
        "final_norm": ("embed",),
    }
    if not cfg.tie_embeddings:
        axes["unembed"] = ("embed_fsdp", "vocab")
    layer: dict = {
        "ln1": L + ("embed",),
        "ln2": L + ("embed",),
    }
    if cfg.layer_kind in ("attn", "hybrid"):
        layer["attn"] = {
            "wq": L + ("embed_fsdp", "heads", "head_dim"),
            "wk": L + ("embed_fsdp", "kv_heads", "head_dim"),
            "wv": L + ("embed_fsdp", "kv_heads", "head_dim"),
            "wo": L + ("heads", "head_dim", "embed_fsdp"),
        }
        if cfg.qkv_bias:
            layer["attn"]["bq"] = L + ("heads", "head_dim")
            layer["attn"]["bk"] = L + ("kv_heads", "head_dim")
            layer["attn"]["bv"] = L + ("kv_heads", "head_dim")
    if cfg.layer_kind in ("mamba", "hybrid"):
        layer["ssm"] = {
            "in_proj": L + ("embed_fsdp", "ssm_inner"),
            "gate_proj": L + ("embed_fsdp", "ssm_inner"),
            "conv_w": L + ("conv", "ssm_inner"),
            "x_proj_b": L + ("ssm_inner", "ssm_state"),
            "x_proj_c": L + ("ssm_inner", "ssm_state"),
            "dt_proj": L + ("ssm_inner",),
            "a_log": L + ("ssm_inner", "ssm_state"),
            "d_skip": L + ("ssm_inner",),
            "out_proj": L + ("ssm_inner", "embed_fsdp"),
        }
    if cfg.moe is not None:
        layer["moe"] = {
            "router": L + ("embed", "experts"),
            "wi": L + ("experts", "embed_fsdp", "expert_ff"),
            "wg": L + ("experts", "embed_fsdp", "expert_ff"),
            "wo": L + ("experts", "expert_ff", "embed_fsdp"),
        }
        if cfg.moe.n_shared_experts:
            layer["shared_mlp"] = {
                "wi": L + ("embed_fsdp", "ff"),
                "wg": L + ("embed_fsdp", "ff"),
                "wo": L + ("ff", "embed_fsdp"),
            }
    elif cfg.d_ff > 0:  # d_ff == 0: no FFN sub-block (pure-Mamba archs)
        layer["mlp"] = {
            "wi": L + ("embed_fsdp", "ff"),
            "wo": L + ("ff", "embed_fsdp"),
        }
        if cfg.act in ("swiglu", "geglu"):
            layer["mlp"]["wg"] = L + ("embed_fsdp", "ff")
    axes["layers"] = layer
    return axes


def fit_sharding_tree(shapes_tree, axes_tree, mesh):
    """``Sharding`` tree: logical axes resolved against actual shapes (the
    leaves of ``shapes_tree`` are tensors, e.g. on the ``meta`` device)."""
    return map_axes(
        lambda ax, t: Sharding(mesh, _fit_spec(spec_for(*ax, mesh=mesh), tuple(t.shape), mesh)),
        axes_tree,
        shapes_tree,
    )


def param_shardings(cfg, mesh, serve: bool = False):
    """``Sharding`` tree matching ``init_params(cfg)`` (shape-aware, from
    its ``meta`` shapes: no weights are drawn)."""
    from repro_torch.models.transformer import init_params

    axes = param_logical_axes(cfg)
    if serve:
        axes = serve_overlay(axes)
    return fit_sharding_tree(init_params(cfg, device="meta"), axes, mesh)


def cache_logical_axes(cfg) -> dict:
    """Logical axes per cache entry (the reference dry run's
    ``_cache_logical_axes``); structure mirrors ``init_kv_cache``."""
    ax = {"pos": ()}
    kv_seq = "kv_seq" if cfg.kv_shard_mode == "seq" else "seq"
    if cfg.layer_kind in ("attn", "hybrid"):
        ax["k"] = ("layers", "batch", kv_seq, "kv_heads", "head_dim")
        ax["v"] = ("layers", "batch", kv_seq, "kv_heads", "head_dim")
        ax["cache_pos"] = ("layers", "seq")
    if cfg.layer_kind in ("mamba", "hybrid"):
        ax["conv"] = ("layers", "batch", "conv", "ssm_inner")
        ax["h"] = ("layers", "batch", "ssm_inner", "ssm_state")
    return ax


def batch_sharding(mesh, batch_size: int, ndim: int) -> Sharding:
    """Shard the leading (batch) dim over as much of (pod, data) as divides."""
    kept: list[str] = []
    size = 1
    for a in (a for a in ("pod", "data") if a in axis_names(mesh)):
        if batch_size % (size * axis_size(mesh, a)) == 0:
            kept.append(a)
            size *= axis_size(mesh, a)
    first = tuple(kept) if len(kept) > 1 else (kept[0] if kept else None)
    return Sharding(mesh, (first,) + (None,) * (ndim - 1))


def lies(t) -> tuple:
    """A DTensor's placements with every ``Shard`` dim counted from the
    front (DTensor's own ops may leave one negative, which a placement
    given to ``redistribute`` or ``local_map`` must not be)."""
    from torch.distributed.tensor import Shard

    return tuple(Shard(p.dim % t.ndim) if isinstance(p, Shard) else p for p in t.placements)


def distribute(t: torch.Tensor, sharding: Sharding):
    """``t``, the same whole tensor on every rank, as a DTensor of
    ``sharding``: each rank keeps its own shard, with no collective."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, sharding.mesh, sharding.placements, src_data_rank=None)


def distribute_params(params, mesh, shardings):
    """The tree ``params`` (whole tensors, the same on every rank) as
    DTensors on ``mesh`` by the ``shardings`` tree (``param_shardings``)."""
    if isinstance(params, dict):
        return {k: distribute_params(v, mesh, shardings[k]) for k, v in params.items()}
    if shardings.mesh is not mesh:
        raise ValueError("a sharding of another mesh")
    return distribute(params, shardings)


def full_tree(tree):
    """Every DTensor leaf of ``tree`` gathered to a whole tensor (the
    checkpoint writer's view); other leaves as they are."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: full_tree(v) for k, v in tree.items()}
    return tree.full_tensor() if isinstance(tree, DTensor) else tree


# ---------------------------------------------------------------------------
# the ambient mesh and activation constraints
# ---------------------------------------------------------------------------
_MESH: list = []  # the ambient mesh stack; its last entry is current
_MESH_OPS = [0]  # depth of nested ``mesh_ops`` blocks


def get_mesh():
    """The ambient mesh, or ``None`` when none is set."""
    return _MESH[-1] if _MESH else None


@contextlib.contextmanager
def set_mesh(mesh):
    """Make ``mesh`` the ambient mesh inside the ``with`` block (``None``
    for none); ``constrain`` and the MoE layer read it."""
    _MESH.append(mesh)
    try:
        yield mesh
    finally:
        _MESH.pop()


@contextlib.contextmanager
def mesh_ops():
    """Under the ambient mesh, the tensors a step makes itself (positions,
    masks, zeros: the same on every rank) join DTensor ops as replicated
    (``implicit_replication``); with no mesh set, nothing changes.  The
    steps enter it once around their forward and backward; nested blocks
    are free."""
    if get_mesh() is None or _MESH_OPS[0]:
        _MESH_OPS[0] += 1
        try:
            yield
        finally:
            _MESH_OPS[0] -= 1
        return
    from torch.distributed.tensor.experimental import implicit_replication

    _MESH_OPS[0] += 1
    try:
        with implicit_replication():
            yield
    finally:
        _MESH_OPS[0] -= 1


def constrain(x, *logical_axes):
    """``with_sharding_constraint`` by logical axes: a DTensor under the
    ambient mesh is redistributed to the placements of ``logical_axes``
    fitted to its shape; a plain tensor, or any tensor with no mesh set,
    is returned as it is (CPU smoke tests)."""
    from torch.distributed.tensor import DTensor

    mesh = get_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    spec = _fit_spec(spec_for(*logical_axes, mesh=mesh), tuple(x.shape), mesh)
    placements = placements_for(mesh, spec)
    if lies(x) == placements:
        return x
    return x.redistribute(mesh, placements)
