"""Checkpointing and the persistent plan store: atomic, versioned,
crash-safe.

The port of ``repro.checkpoint.store`` (the port imports nothing of the
JAX package), with the same on-disk formats, so a step checkpoint or a plan
either package writes restores in the other.

**Step checkpoints** (``save_checkpoint``/``restore_checkpoint``): one
``.npy`` a leaf of the state tree (tensors are brought to the host) and a
``manifest.json`` with the tree's structure (``index`` and ``tree``).  A
bf16 leaf is written as the reference writes one, its 2-byte values raw
(numpy's ``V2``, written through ``int16``, so no ``ml_dtypes`` is
needed), and a ``V2`` leaf is restored as ``torch.bfloat16`` with the same
bits; the reference's own restore gives those leaves back as ``V2`` bytes.
``restore_checkpoint`` returns tensors on the host, or on ``device``
(where the reference takes ``shardings``).

**Plan store** (``save_plan``/``restore_plan``): lowered ``ExecutionPlan``
objects are keyed by structure fingerprint and written as one
``arrays.npz`` (every ndarray field) plus a versioned
``manifest.json`` (scalar fields, route metadata, a sha256 over the array
file).  A restarted session rebuilds its warm executor pool from here
instead of re-partitioning and re-lowering the world.  Corrupt or
version-mismatched entries are *quarantined* — renamed aside and logged,
never fatal — so a bad byte on disk costs one replan, not the process.
Every plan class of the reference, ``SummaPlan`` included, restores here.

Commit protocol: write the payload into a ``*.tmp`` sibling, rename any
existing final dir aside to ``*.prev``, ``os.replace`` the tmp into place,
then drop the ``.prev``.  Every crash window leaves either the old or the
new copy intact; readers call ``_recover_prev`` to promote an orphaned
``.prev`` back after a crash between the two renames.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import shutil

import numpy as np
import torch

PLAN_STORE_VERSION = 1
_KEY_RE = re.compile(r"[A-Za-z0-9_-]+")


class PlanStoreError(RuntimeError):
    """A plan-store entry failed integrity checks (corrupt, truncated, or
    written by an incompatible version).  Permanent for that entry — the
    caller quarantines and replans instead of retrying."""


# ---------------------------------------------------------------------------
# crash-safe directory commit
# ---------------------------------------------------------------------------
def _commit_dir(tmp: str, final: str) -> None:
    """Atomically promote ``tmp`` to ``final``.

    The old final (if any) is renamed aside to ``final + ".prev"`` first, so
    at every instant at least one complete copy exists under a recoverable
    name; ``os.replace`` then moves the new dir into place and the ``.prev``
    is dropped."""
    prev = final + ".prev"
    if os.path.exists(prev):
        shutil.rmtree(prev)
    if os.path.exists(final):
        os.rename(final, prev)
    os.replace(tmp, final)
    if os.path.exists(prev):
        shutil.rmtree(prev)


def _recover_prev(final: str) -> None:
    """Reader-side crash recovery for ``_commit_dir``: an orphaned ``.prev``
    with no final (crash between the two renames) is promoted back; a stale
    ``.prev`` next to a live final (crash before cleanup) is dropped."""
    prev = final + ".prev"
    if not os.path.exists(prev):
        return
    if os.path.exists(final):
        shutil.rmtree(prev, ignore_errors=True)
    else:
        os.rename(prev, final)


# ---------------------------------------------------------------------------
# pytree <-> flat arrays
# ---------------------------------------------------------------------------
def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in sorted(tree.items()):
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: dict, manifest):
    if isinstance(manifest, dict) and manifest.get("__leaf__"):
        return flat[manifest["key"]]
    if isinstance(manifest, dict) and "__tuple__" in manifest:
        return tuple(_unflatten(flat, v) for v in manifest["__tuple__"])
    if isinstance(manifest, dict):
        return {k: _unflatten(flat, v) for k, v in manifest.items()}
    if isinstance(manifest, list):
        return [_unflatten(flat, v) for v in manifest]
    raise TypeError(type(manifest))


def _manifest_of(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: _manifest_of(v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, tuple):
        return {
            "__tuple__": [_manifest_of(v, f"{prefix}{i}/") for i, v in enumerate(tree)]
        }
    if isinstance(tree, list):
        return [_manifest_of(v, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return {"__leaf__": True, "key": prefix[:-1]}


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as the array ``np.save`` writes: tensors from any device; a
    bf16 tensor as its raw 2-byte values (``V2``, the bytes the reference
    writes for an ``ml_dtypes`` bfloat16 array)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    return np.asarray(leaf)


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    """A loaded leaf as a tensor: ``V2`` (a bf16 leaf of either package)
    as ``torch.bfloat16`` with the same bits."""
    if not a.flags.c_contiguous:  # (np.ascontiguousarray makes 0-d arrays 1-d)
        a = a.copy(order="C")
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t if device is None else t.to(device)


# ---------------------------------------------------------------------------
# step checkpoints
# ---------------------------------------------------------------------------
def save_checkpoint(ckpt_dir: str, step: int, state, keep_last: int = 3) -> str:
    """Atomically write ``state`` (a tree of tensors or arrays) for ``step``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp-{step}")
    final = os.path.join(ckpt_dir, f"step_{step:012d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = _flatten(state)
    index = {}
    for key, arr in flat.items():
        fname = key.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fname), _to_numpy(arr))
        index[key] = fname
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(
            {"step": step, "index": index, "tree": _manifest_of(state)}, f, indent=1
        )
    _commit_dir(tmp, final)
    _gc(ckpt_dir, keep_last)
    return final


def _gc(ckpt_dir: str, keep_last: int):
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:012d}"), ignore_errors=True)


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d{12})\.prev", name)
        if m:
            _recover_prev(os.path.join(ckpt_dir, name[: -len(".prev")]))
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d{12})", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, step: int | None = None, device=None):
    """Load a checkpoint as ``(state, step)``: a tree of tensors on the host,
    or on ``device`` (the reference's ``shardings``: the elastic-rescale
    path, which here places the state on whatever device the restarted job
    has)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:012d}")
    _recover_prev(d)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    device = None if device is None else torch.device(device)
    flat = {
        key: _to_tensor(np.load(os.path.join(d, fname)), device)
        for key, fname in manifest["index"].items()
    }
    return _unflatten(flat, manifest["tree"]), step


# ---------------------------------------------------------------------------
# persistent plan store
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class RestoredPlan:
    """One plan-store entry read back: the rebuilt ``ExecutionPlan``, the
    caller's side arrays (partition labels, warm-start vertex keys, ...) and
    the caller's JSON metadata."""

    key: str
    plan: object
    arrays: dict[str, np.ndarray]
    meta: dict


_ROUTE_SCALARS = (
    "payload",
    "items_ideal",
    "items_padded",
    "word_size",
    "words_ideal_override",
    "words_padded_override",
)


def _plan_classes():
    from repro_torch.distributed import plan_ir, summa

    return {
        cls.__name__: cls
        for cls in (
            plan_ir.ExecutionPlan,
            plan_ir.RowwisePlan,
            plan_ir.OuterPlan,
            plan_ir.MonoCPlan,
            plan_ir.FinePlan,
            summa.SummaPlan,
        )
    }


def _check_key(key: str) -> str:
    if not _KEY_RE.fullmatch(key):
        raise ValueError(f"plan key must match [A-Za-z0-9_-]+, got {key!r}")
    return key


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def save_plan(
    store_dir: str,
    key: str,
    plan,
    arrays: dict[str, np.ndarray] | None = None,
    meta: dict | None = None,
) -> str:
    """Atomically persist ``plan`` (an ``ExecutionPlan``) under ``key``.

    ``arrays``: extra ndarrays to store alongside the plan (the session puts
    partition labels and warm-start vertex keys here).  ``meta``: extra
    JSON-serializable metadata (fingerprints, model selection, ...).
    Returns the committed directory."""
    from repro_torch.testing import faults

    faults.fire("store_save")
    _check_key(key)
    os.makedirs(store_dir, exist_ok=True)
    final = os.path.join(store_dir, key)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    blobs: dict[str, np.ndarray] = {}
    for name, arr in plan.ownership.items():
        blobs[f"own__{name}"] = np.asarray(arr)
    for name, arr in plan.local_ids.items():
        blobs[f"lid__{name}"] = np.asarray(arr)
    for name, route in plan.routes.items():
        blobs[f"route__{name}__send_idx"] = route.send_idx
        blobs[f"route__{name}__recv_key"] = route.recv_key
    for name, arr in plan.compute.items():
        blobs[f"cmp__{name}"] = np.asarray(arr)
    for name, arr in (arrays or {}).items():
        blobs[f"extra__{name}"] = np.asarray(arr)
    arr_path = os.path.join(tmp, "arrays.npz")
    np.savez_compressed(arr_path, **blobs)

    manifest = {
        "format": "repro-plan-store",
        "version": PLAN_STORE_VERSION,
        "key": key,
        "plan_class": type(plan).__name__,
        "model": plan.model,
        "p": int(plan.p),
        "routes": {
            name: {
                field: (
                    None
                    if getattr(route, field) is None
                    else getattr(route, field)
                    if field == "payload"
                    else int(getattr(route, field))
                )
                for field in _ROUTE_SCALARS
            }
            for name, route in plan.routes.items()
        },
        "stats": {k: int(v) for k, v in plan.stats.items()},
        "arrays_sha256": _sha256(arr_path),
        "meta": meta or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    _commit_dir(tmp, final)
    return final


def _read_plan_entry(entry_dir: str, key: str) -> RestoredPlan:
    """Parse + integrity-check one entry; raises ``PlanStoreError`` on any
    corruption or version mismatch (the quarantinable failures)."""
    man_path = os.path.join(entry_dir, "manifest.json")
    arr_path = os.path.join(entry_dir, "arrays.npz")
    try:
        with open(man_path) as f:
            manifest = json.load(f)
    except FileNotFoundError as e:
        raise PlanStoreError(f"plan {key!r}: missing manifest") from e
    except json.JSONDecodeError as e:
        raise PlanStoreError(f"plan {key!r}: corrupt manifest: {e}") from e
    if manifest.get("format") != "repro-plan-store":
        raise PlanStoreError(f"plan {key!r}: not a plan-store entry")
    version = manifest.get("version")
    if version != PLAN_STORE_VERSION:
        raise PlanStoreError(
            f"plan {key!r}: version {version} != {PLAN_STORE_VERSION}"
        )
    if not os.path.exists(arr_path):
        raise PlanStoreError(f"plan {key!r}: missing arrays.npz")
    digest = _sha256(arr_path)
    if digest != manifest.get("arrays_sha256"):
        raise PlanStoreError(
            f"plan {key!r}: arrays.npz checksum mismatch "
            f"({digest[:12]} != {str(manifest.get('arrays_sha256'))[:12]})"
        )
    cls = _plan_classes().get(manifest.get("plan_class"))
    if cls is None:
        raise PlanStoreError(
            f"plan {key!r}: unknown plan class {manifest.get('plan_class')!r}"
        )

    from repro_torch.distributed.plan_ir import Route

    try:
        with np.load(arr_path) as z:
            blobs = {name: z[name] for name in z.files}
    except Exception as e:  # zipfile/np errors on truncated archives
        raise PlanStoreError(f"plan {key!r}: unreadable arrays.npz: {e}") from e

    ownership, local_ids, compute, extra = {}, {}, {}, {}
    route_arrays: dict[str, dict[str, np.ndarray]] = {}
    for name, arr in blobs.items():
        if name.startswith("own__"):
            ownership[name[5:]] = arr
        elif name.startswith("lid__"):
            local_ids[name[5:]] = arr
        elif name.startswith("cmp__"):
            compute[name[5:]] = arr
        elif name.startswith("extra__"):
            extra[name[7:]] = arr
        elif name.startswith("route__"):
            rname, _, field = name[7:].rpartition("__")
            route_arrays.setdefault(rname, {})[field] = arr
        else:
            raise PlanStoreError(f"plan {key!r}: unexpected array {name!r}")
    routes = {}
    try:
        for rname, scalars in manifest["routes"].items():
            arrs = route_arrays[rname]
            routes[rname] = Route(
                payload=scalars["payload"],
                send_idx=arrs["send_idx"],
                recv_key=arrs["recv_key"],
                items_ideal=scalars["items_ideal"],
                items_padded=scalars["items_padded"],
                word_size=scalars["word_size"],
                words_ideal_override=scalars["words_ideal_override"],
                words_padded_override=scalars["words_padded_override"],
            )
        plan = cls(
            model=manifest["model"],
            p=int(manifest["p"]),
            ownership=ownership,
            local_ids=local_ids,
            routes=routes,
            compute=compute,
            stats=dict(manifest["stats"]),
        )
    except KeyError as e:
        raise PlanStoreError(f"plan {key!r}: manifest/arrays mismatch: {e}") from e
    return RestoredPlan(key=key, plan=plan, arrays=extra, meta=manifest["meta"])


def quarantine_plan(store_dir: str, key: str, reason: str = "") -> str | None:
    """Rename a bad entry aside (``<key>.quarantined-<n>``) and log it.
    Returns the quarantine path, or None if the entry vanished meanwhile."""
    import warnings

    entry = os.path.join(store_dir, _check_key(key))
    if not os.path.exists(entry):
        return None
    n = 0
    while os.path.exists(dst := f"{entry}.quarantined-{n}"):
        n += 1
    os.rename(entry, dst)
    warnings.warn(
        f"plan store: quarantined {key!r} -> {os.path.basename(dst)}"
        + (f" ({reason})" if reason else ""),
        RuntimeWarning,
        stacklevel=2,
    )
    return dst


def restore_plan(
    store_dir: str, key: str, quarantine: bool = True
) -> RestoredPlan | None:
    """Read back one plan-store entry.

    Returns None when the entry does not exist — and, with ``quarantine``
    (the default), also when it exists but fails integrity checks, in which
    case it is renamed aside first (a bad entry costs one replan, never the
    process).  With ``quarantine=False`` integrity failures raise
    ``PlanStoreError``.  Transient IO errors propagate either way (they are
    retryable; quarantining on them would discard good data)."""
    from repro_torch.testing import faults

    faults.fire("store_restore")
    entry = os.path.join(store_dir, _check_key(key))
    _recover_prev(entry)
    if not os.path.isdir(entry):
        return None
    try:
        return _read_plan_entry(entry, key)
    except PlanStoreError as e:
        if not quarantine:
            raise
        quarantine_plan(store_dir, key, reason=str(e))
        return None


def list_plans(store_dir: str) -> list[str]:
    """Keys of the committed (non-quarantined, non-tmp) entries."""
    if not os.path.isdir(store_dir):
        return []
    for name in os.listdir(store_dir):
        if name.endswith(".prev"):
            _recover_prev(os.path.join(store_dir, name[: -len(".prev")]))
    out = []
    for name in os.listdir(store_dir):
        if _KEY_RE.fullmatch(name) and os.path.isdir(os.path.join(store_dir, name)):
            out.append(name)
    return sorted(out)
