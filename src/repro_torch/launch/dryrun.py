"""Multi-pod dry run (the port of ``repro.launch.dryrun``, the reference's
deliverable (e)).

For every (architecture x input shape) cell, on the 16x16 single-pod mesh
and the 2x16x16 multi-pod mesh: start a ``fake`` process group of 256 or
512 ranks in this one process (this process is rank 0), build the
production mesh on it, and, under ``FakeTensorMode``, draw the parameters
at full depth and width, the optimizer state, the batch and (decode) the
cache, distribute them as DTensors by the sharding rules
(``models.sharding``), and run the step once: train with its backward,
prefill, or decode.  No storage is ever allocated and no accelerator is
needed.  Each cell records:

- ``memory``: per device, the bytes of the arguments' local shards, of the
  outputs' local shards, and the peak of the bytes the step allocated at
  once (``temp_size_in_bytes``, its outputs as they were built included);
- ``flops``: the step's FLOPs by ``torch.utils.flop_counter``'s formulas,
  a DTensor op at its global shapes and an op of a ``local_map`` region
  (attention, the MoE's expert products) at this rank's shapes times the
  mesh size (distinct work where the region's inputs split over every
  mesh dim; a region replicated over a dim is counted on each rank
  there), and ``flops_per_device``: every op this rank runs, at its
  local shapes;
- ``bytes_accessed``: per device, the sum over the ops this rank runs of
  their operands' and results' bytes (no fusion);
- ``collectives``: per kind (the reference's names: ``all-gather``,
  ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
  ``collective-permute``), the count and the local result bytes of every
  collective this rank issues, DTensor's redistributions and the MoE's
  all-reduce alike (``Census``, a ``TorchDispatchMode``: the counterpart
  of parsing the compiled HLO), and ``wire_bytes`` from them;
- ``trace_s``: the seconds the step took to run under fake tensors.

Every layer runs, so unlike the reference (which compiles depths 2 and 4
and extrapolates, XLA counting a loop body once) nothing is extrapolated.
The ``donate`` opt has no meaning here: the port's steps update in place.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-moe-235b-a22b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out build/dryrun]
  python -m repro_torch.launch.dryrun --arch internlm2-1.8b --shape train_4k --multi-pod \
      --layers 2   # depth cut to 2 layers (the record's file name ends _L2)
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs import all_arch_ids, get_config
from repro_torch.configs.shapes import (
    SHAPES,
    ShapeSpec,
    cache_specs,
    input_specs,
    shape_applicable,
)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import init_params
from repro_torch.models.sharding import (
    batch_sharding,
    cache_logical_axes,
    distribute,
    distribute_params,
    fit_sharding_tree,
    param_shardings,
)
from repro_torch.training.optimizer import adamw_init
from repro_torch.training.step import make_decode_step, make_prefill_step, make_train_step

OPTS = ("serve_shardings", "donate", "remat_dots", "remat_none", "seq_shard",
        "gather_weights", "kv_none", "kv_seq")

# collective ops (their overload packets' names) -> the reference's kinds
_KINDS = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_coalesced_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
}  # any other collective is counted under its own name
_NAMESPACES = ("_c10d_functional", "c10d_functional", "_c10d_functional_autograd", "c10d")


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for e in x for t in _tensors(e)]
    if isinstance(x, dict):
        return [t for e in x.values() for t in _tensors(e)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Local(TorchDispatchMode):
    """``Census``'s view inside a DTensor op: hands DTensor ops on to
    DTensor (``NotImplemented``), so the local ops and collectives that
    DTensor issues for it come back here, at this rank's shapes."""

    def __init__(self, census: "Census"):
        super().__init__()
        self.census = census

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        return self.census._run_local(func, args, kwargs or {}, top=False)


class Census(TorchDispatchMode):
    """Counts what one rank runs: every collective (``_c10d_functional.*``
    and ``c10d.*``, not ``wait_tensor``) by kind with its local result
    bytes, the FLOPs by ``FlopCounterMode``'s formulas (``flops``: a
    DTensor op at its global shapes, an op outside DTensor, a
    ``local_map`` region's, at this rank's shapes times ``n_ranks``, the
    mesh size; ``flops_per_device``: every op at local shapes), the
    unfused operand and result bytes of every local op, and the peak of
    the bytes alive at once that the counted ops allocated.  A DTensor op
    is counted at its global shapes and then run with ``_Local`` on the
    mode stack, which sees the ops DTensor issues for it.  The ops DTensor runs only to learn an
    output's shape (on ``empty_strided`` or ``meta`` stand-ins of the
    global shape) are not counted."""

    def __init__(self, n_ranks: int = 1):
        super().__init__()
        self.n_ranks = n_ranks
        self.collectives: dict[str, dict[str, int]] = {}
        self.flops = 0  # global
        self.flops_per_device = 0
        self.bytes_accessed = 0
        self.live = 0
        self.peak = 0
        self._shadow = WeakIdKeyDictionary()  # DTensor's shape-propagation stand-ins
        self._storages: dict[int, list] = {}  # storage -> [bytes, tensors alive]

    def record(self) -> dict:
        return {
            "collectives": {k: dict(v) for k, v in sorted(self.collectives.items())},
            "flops": self.flops, "flops_per_device": self.flops_per_device,
            "bytes_accessed": self.bytes_accessed, "peak_bytes": self.peak,
        }

    @staticmethod
    def _flops(func, args, kwargs, out) -> int:
        count = flop_registry.get(func._overloadpacket)
        return int(count(*args, **kwargs, out_val=out)) if count else 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            self.flops += self._flops(func, args, kwargs, None)
            with _Local(self):
                return func(*args, **kwargs)
        return self._run_local(func, args, kwargs, top=True)

    def _track(self, t: torch.Tensor, in_storages: set) -> None:
        """Count ``t``'s storage alive until its last counted tensor dies: a
        new storage from its first tensor on, a view of a counted one while
        the view lives; a view of (or a write into) a storage the step did
        not allocate, such as an argument's, is not counted."""
        key = t.untyped_storage()._cdata
        entry = self._storages.get(key)
        if entry is None:
            if key in in_storages:
                return
            entry = self._storages[key] = [t.untyped_storage().nbytes(), 0]
            self.live += entry[0]
            self.peak = max(self.peak, self.live)
        entry[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        entry = self._storages[key]
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._storages[key]

    def _run_local(self, func, args, kwargs, top: bool):
        out = func(*args, **kwargs)
        ins = _tensors(args) + _tensors(kwargs)
        outs = _tensors(out)
        if (func is torch.ops.aten.empty_strided.default and not top) or any(
                t in self._shadow for t in ins) or any(t.device.type == "meta" for t in outs):
            self._shadow.update((t, True) for t in outs)
            return out
        packet = func._overloadpacket
        namespace = packet._qualified_op_name.split("::")[0]
        name = packet.__name__
        if namespace in _NAMESPACES:
            if name not in ("wait_tensor", "_wrap_tensor_autograd"):  # moves nothing
                kind = _KINDS.get(name, name)
                result = _tensors(args[0]) if namespace == "c10d" else outs
                rec = self.collectives.setdefault(kind, {"count": 0, "result_bytes": 0})
                rec["count"] += 1
                rec["result_bytes"] += sum(_nbytes(t) for t in result)
            return out
        flops = self._flops(func, args, kwargs, out)
        self.flops_per_device += flops
        if top:  # a local_map region's op, run on every rank on its own shards
            self.flops += flops * self.n_ranks
        self.bytes_accessed += sum(_nbytes(t) for t in ins + outs)
        in_storages = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            self._track(t, in_storages)
        return out


def wire_bytes(census: dict, factor_all_reduce: float = 2.0) -> int:
    """Ring-model effective wire bytes: AG/RS/A2A ~ result bytes, AR ~ 2x."""
    total = 0
    for kind, rec in census.items():
        f = factor_all_reduce if kind == "all-reduce" else 1.0
        total += int(rec["result_bytes"] * f)
    return total


def _local_bytes(tree) -> int:
    return sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t) for t in _tensors(tree))


def _like(tree, device):
    """Tensors (fake, under ``FakeTensorMode``) on ``device`` shaped as the
    ``meta`` tensors of ``tree``."""
    if isinstance(tree, dict):
        return {k: _like(v, device) for k, v in tree.items()}
    return torch.zeros(tree.shape, dtype=tree.dtype, device=device)


def cell_config(arch: str, opts=(), cfg=None):
    """The config of a cell with the opts' knobs set, as ``build_cell``."""
    cfg = cfg or get_config(arch)
    knobs = {"remat_dots": {"remat_policy": "dots"}, "remat_none": {"remat_policy": "none"},
             "seq_shard": {"seq_shard_residual": True}, "gather_weights": {"gather_weights": True},
             "kv_none": {"kv_shard_mode": "none"}, "kv_seq": {"kv_shard_mode": "seq"}}
    for opt in opts:
        if opt not in OPTS:
            raise ValueError(f"unknown opt {opt!r}; known: {OPTS}")
        cfg = dataclasses.replace(cfg, **knobs.get(opt, {}))
    return cfg


def build_cell(arch: str, shape: str, mesh, cfg=None, opts=()):
    """(step, args) for the cell on ``mesh``: the step function and its
    arguments as DTensors (fake under ``FakeTensorMode``: the parameters
    shaped by ``init_params`` at full depth and width), by the rules."""
    cfg = cell_config(arch, opts, cfg)
    spec = shape if isinstance(shape, ShapeSpec) else SHAPES[shape]
    serve = "serve_shardings" in opts and spec.kind in ("prefill", "decode")
    dev = mesh.device_type
    params = distribute_params(_like(init_params(cfg, device="meta"), dev), mesh,
                               param_shardings(cfg, mesh, serve=serve))
    batch = {k: distribute(v, batch_sharding(mesh, v.shape[0], v.ndim))
             for k, v in _like(input_specs(cfg, shape), dev).items()}
    if spec.kind == "train":
        return make_train_step(cfg), (params, adamw_init(params), batch)
    if spec.kind == "prefill":
        return make_prefill_step(cfg), (params, batch)
    cache = _like(cache_specs(cfg, shape), dev)
    shardings = fit_sharding_tree(cache, cache_logical_axes(cfg), mesh)
    cache = {k: distribute(v, shardings[k]) for k, v in cache.items()}
    return make_decode_step(cfg), (params, cache, batch["tokens"])


def start_fake_group(world: int) -> None:
    """A ``fake`` process group of ``world`` ranks in this process (rank 0):
    collectives return at once, with results of the right shapes."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: str | None, opts: tuple = (),
             n_layers: int | None = None) -> dict:
    """One cell on the production mesh over a fake group, on fake CPU
    tensors: DTensor moves data as over gloo, which has no all-to-all (a
    shard moves between dims by an all-gather and a local chunk); with
    ``n_layers``, at that depth instead of the published one."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    base = get_config(arch)
    if n_layers is not None:
        base = dataclasses.replace(base, n_layers=n_layers)
    cfg = cell_config(arch, opts, base)
    ok, why = shape_applicable(cfg, shape)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name, "opts": list(opts),
           "status": "skipped", "reason": why}
    if not ok:
        print(f"[dryrun] SKIP {arch} x {shape} ({why})")
        return rec
    t0 = time.time()
    try:
        start_fake_group(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        with FakeTensorMode():
            step, args = build_cell(arch, shape, mesh, cfg=base, opts=opts)
            t_build = time.time() - t0
            census = Census(mesh.size())
            t1 = time.time()
            with census:
                out = step(*args)
            trace_s = time.time() - t1
            counts = census.record()
            memory = {
                "argument_size_in_bytes": _local_bytes(args),
                "output_size_in_bytes": _local_bytes(out),
                "temp_size_in_bytes": counts["peak_bytes"],
            }
            del out, args
        rec.update(
            status="ok", n_devices=mesh.size(), n_layers=cfg.n_layers,
            build_s=round(t_build, 1), trace_s=trace_s, memory=memory,
            flops=counts["flops"], flops_per_device=counts["flops_per_device"],
            bytes_accessed=counts["bytes_accessed"], collectives=counts["collectives"],
            wire_bytes=wire_bytes(counts["collectives"]),
        )
        print(f"[dryrun] OK {arch} x {shape} x {mesh_name}: flops={rec['flops']:.3e} "
              f"flops/dev={rec['flops_per_device']:.3e} bytes/dev={rec['bytes_accessed']:.3e} "
              f"wire={rec['wire_bytes']:.3e} temp/dev={memory['temp_size_in_bytes'] / 1e9:.2f}GB "
              f"(build {t_build:.0f}s trace {trace_s:.0f}s)")
        print(f"[dryrun]   memory: {memory}")
        print(f"[dryrun]   collectives: {json.dumps(rec['collectives'])}")
    except Exception as e:  # the boundary of a cell: record it, go on to the next
        rec.update(status="error", error=f"{type(e).__name__}: {e}")
        print(f"[dryrun] FAIL {arch} x {shape} x {mesh_name}: {e}")
        traceback.print_exc()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = ("+" + "+".join(opts)) if opts else ""
        tag += f"_L{n_layers}" if n_layers is not None else ""
        fname = f"{arch}_{shape}_{mesh_name}{tag}.json".replace("/", "_")
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=all_arch_ids())
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--opt", default="", help="comma list of " + ",".join(OPTS))
    ap.add_argument("--layers", type=int, default=None, help="cut every config to this depth")
    args = ap.parse_args(argv)
    opts = tuple(o for o in args.opt.split(",") if o)

    archs = all_arch_ids() if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) else [args.multi_pod]
    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                rec = run_cell(arch, shape, mp, args.out, opts=opts, n_layers=args.layers)
                n_fail += rec["status"] == "error"
    sys.exit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
