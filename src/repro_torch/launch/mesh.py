"""Mesh construction (the port of ``repro.launch.mesh``).

Functions, not module-level state, so importing this module starts no
process group.  Single pod: 16 x 16 = 256 devices (data, model).
Multi-pod: 2 x 16 x 16 = 512 devices (pod, data, model); the 'pod' axis is
pure data parallelism across the inter-pod links.

Each mesh is ``torch.distributed.device_mesh.init_device_mesh`` over the
ranks of the default process group, on the card unless the caller passes
``device_type="cpu"``; the group's world size must equal the mesh's size.
The multi-pod dry run (``launch.dryrun``) builds the production meshes
over a ``fake`` group of 256 or 512 ranks in one process.
"""
from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

__all__ = ["make_host_mesh", "make_mesh", "make_production_mesh"]


def _device_type(device_type: str | None) -> str:
    """``"cuda"`` unless the caller names another; the card must be there."""
    device_type = device_type or "cuda"
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device_type='cpu' for a mesh on the CPU"
        )
    return device_type


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], device_type: str | None = None):
    """Elastic entry point: any (pod, data, model) factorization."""
    from torch.distributed.device_mesh import init_device_mesh

    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    return init_device_mesh(_device_type(device_type), tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str | None = None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_host_mesh(model: int = 1, device_type: str | None = None):
    """A (data, model) mesh over the ranks of the default process group,
    ``data = world // model``.  With no default group, this starts a
    one-rank group itself (gloo on the CPU, NCCL on the card, through a
    store on this host); a group that fails to start raises."""
    device_type = _device_type(device_type)
    if not dist.is_initialized():
        store = dist.HashStore()
        backend = "nccl" if device_type == "cuda" else "gloo"
        dist.init_process_group(backend, store=store, rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=600))
    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"model axis {model} does not divide the {n} ranks")
    return make_mesh((n // model, model), ("data", "model"), device_type)
