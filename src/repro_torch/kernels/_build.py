"""Build the port's CUDA sources with nvcc on first use; load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``build/repro_torch_kernels/`` at the repository root, named by a hash
of its source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source rebuilds and an unchanged one is compiled once.  Nothing here
runs at import time: the CPU tests import every module on a machine without
nvcc.  The checks every wrapper makes before it hands pointers to a kernel
live here too.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # per-kernel registers / shared memory / spills in the log
)
# No -lcuda: moe_gemm.cu reaches libcuda's cuTensorMapEncodeTiled through
# the runtime's cudaGetDriverEntryPoint, so every library links the runtime alone.

# element types the kernels take, and their codes in every csrc/*.cu
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_LOADED: dict[str, ctypes.CDLL] = {}


def as_index(x, device: torch.device) -> torch.Tensor:
    """An int32 index tensor on ``device`` from a tensor, array or list."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32)
    return torch.as_tensor(np.asarray(x, dtype=np.int32), device=device)


def check_inputs(values, indices) -> None:
    """Raise unless each ``(name, tensor)`` of ``values`` has a type in
    ``DTYPE_CODE`` and is contiguous, and each of ``indices`` is a
    contiguous 1-D int32 tensor."""
    for name, t in values:
        if t.dtype not in DTYPE_CODE:
            raise TypeError(f"{name} dtype {t.dtype} not in {tuple(DTYPE_CODE)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in indices:
        if t.dtype != torch.int32 or t.ndim != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int32 tensor")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build(name: str) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless its hashed library exists.

    Returns the library's path and the compiler's log (the ``-Xptxas -v``
    lines).  The library is written under a temporary name and renamed into
    place, so concurrent builders never load a half-written file.
    """
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    log = lib.with_suffix(".log")
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
        log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
    return lib, log.read_text() if log.exists() else ""


def build_all() -> dict[str, str]:
    """Build every source in ``csrc/`` at once (one nvcc each, in parallel);
    returns each source's compiler log."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        logs = list(pool.map(lambda n: build(n)[1], names))
    return dict(zip(names, logs))


def sass(name: str) -> str:
    """The SASS of ``csrc/<name>.cu``'s library (``cuobjdump --dump-sass``,
    from the toolkit that holds nvcc), built first if need be."""
    cuobjdump = Path(_nvcc()).parent / "cuobjdump"
    proc = subprocess.run(
        [str(cuobjdump), "--dump-sass", str(build(name)[0])], capture_output=True, text=True
    )
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump failed on lib{name}:\n{proc.stderr}")
    return proc.stdout


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = _LOADED[name] = ctypes.CDLL(str(build(name)[0]))
    return lib
