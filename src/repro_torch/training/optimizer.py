"""Optimizers (the port of ``repro.training.optimizer``): AdamW (fp32
moments) and Adafactor (factored second moment, for the largest MoE configs
where full Adam state would not fit the card).

States mirror the params tree (nested dicts of tensors, as the reference's
pytrees), with the same keys, shapes and dtypes.  To save memory the
updates are made in place: the parameters and the state's moments are
overwritten and returned (the reference returns new trees; its launcher
donates the old ones to the same end).  The numbers are the reference's
functional update's.  Large leaves are updated a slice of their leading
axes at a time (``_CHUNK`` elements), so the fp32 temporaries of a stacked
expert weight never take more than a slice: Adafactor's leaf-wide RMS clip
takes two passes over each factored leaf, the first summing the squares of
the update.

Under a mesh the leaves are DTensors: the state takes each parameter's
placements (Adafactor's factored moments those of the dims they keep), the
gradients must lie as the parameters do (``make_train_step``
redistributes them), AdamW updates each rank's shards as they are (its
update is elementwise), and Adafactor's factored means and its RMS clip,
which reduce over sharded dims, run as DTensor ops on whole leaves.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.sharding import lies

# elements a pass over a leaf takes at once: fp32 temporaries of 256 MB
_CHUNK = 1 << 26


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (nested dicts, lists and tuples of
    tensors) and the matching leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in ``tree_map``'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def _count_device(params) -> torch.device:
    leaves = tree_leaves(params)
    return leaves[0].device if leaves else torch.device("cpu")


def chunk_slices(n: int, per: int):
    """(start, stop) over ``n`` rows of ``per`` elements, at most ``_CHUNK``
    elements (and at least one row) each."""
    step = max(1, _CHUNK // max(per, 1))
    for i in range(0, n, step):
        yield i, min(n, i + step)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's shard on this rank; any other tensor as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


def _same_layout(*leaves) -> None:
    """An elementwise update on shards needs every operand to lie alike."""
    if isinstance(leaves[0], DTensor):
        placements = {lies(t) for t in leaves}
        if len(placements) != 1:
            raise ValueError(f"a parameter, its gradient and state lie differently: {placements}")


def _assign(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)``; a DTensor ``src`` is first redistributed to
    ``dst``'s placements (a reduction for a partial sum)."""
    if isinstance(dst, DTensor) and lies(src) != lies(dst):
        src = src.redistribute(dst.device_mesh, lies(dst))
    dst.copy_(src)


def _zeros32(p: torch.Tensor, shape, drop: int | None = None) -> torch.Tensor:
    """fp32 zeros of ``shape`` where ``p`` lies; for a DTensor ``p``, with
    its placements less dim ``drop`` (a factored moment's reduced dim)."""
    if not isinstance(p, DTensor):
        return torch.zeros(shape, dtype=torch.float32, device=p.device)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor import zeros as dzeros

    def keep(pl):
        if not isinstance(pl, Shard) or drop is None:
            return pl
        return Replicate() if pl.dim == drop else Shard(pl.dim - (pl.dim > drop))

    return dzeros(shape, dtype=torch.float32, device_mesh=p.device_mesh,
                  placements=[keep(pl) for pl in lies(p)])


def adamw_init(params):
    zeros32 = lambda p: _zeros32(p, p.shape)
    return {
        "mu": tree_map(zeros32, params),
        "nu": tree_map(zeros32, params),
        "count": torch.zeros((), dtype=torch.int32, device=_count_device(params)),
    }


@torch.no_grad()
def adamw_update(
    grads,
    state,
    params,
    lr: float,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
):
    """(params, state) after one AdamW step; ``params``, ``state["mu"]``
    and ``state["nu"]`` are updated in place."""
    count = state["count"] + 1
    cf = count.float()
    bc1 = 1 - torch.tensor(b1, dtype=torch.float32, device=cf.device) ** cf
    bc2 = 1 - torch.tensor(b2, dtype=torch.float32, device=cf.device) ** cf

    def upd(g, mu, nu, p):
        _same_layout(p, g, mu, nu)
        pf, gf = _local(p).view(-1), _local(g).reshape(-1)
        muf, nuf = _local(mu).view(-1), _local(nu).view(-1)
        for i, j in chunk_slices(pf.numel(), 1):
            g32 = gf[i:j].float()
            m = muf[i:j].mul_(b1).add_(g32 * (1 - b1))
            v = nuf[i:j].mul_(b2).add_(g32.square().mul_(1 - b2))
            p32 = pf[i:j].float()
            step = (m / bc1) / ((v / bc2).sqrt_() + eps) + weight_decay * p32
            pf[i:j] = p32 - lr * step
        return p

    tree_map(upd, grads, state["mu"], state["nu"], params)
    return params, {"mu": state["mu"], "nu": state["nu"], "count": count}


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern), factored second moment for matrices
# ---------------------------------------------------------------------------
def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def adafactor_init(params):
    def leaf(p):
        if _factored(p.shape):
            return {"vr": _zeros32(p, p.shape[:-1], drop=p.ndim - 1),
                    "vc": _zeros32(p, p.shape[:-2] + p.shape[-1:], drop=p.ndim - 2)}
        return {"v": _zeros32(p, p.shape)}

    return {
        "v": tree_map(leaf, params),
        "count": torch.zeros((), dtype=torch.int32, device=_count_device(params)),
    }


@torch.no_grad()
def adafactor_update(
    grads,
    state,
    params,
    lr: float,
    decay: float = 0.8,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
    weight_decay: float = 0.0,
):
    """(params, state) after one Adafactor step; ``params`` and the state's
    second moments are updated in place."""
    count = state["count"] + 1
    beta2 = 1.0 - count.float() ** (-decay)

    def moments_(g32, vr, vc):
        """A slice's factored second moments, updated in place."""
        g2 = g32.square().add_(eps)
        _assign(vr, beta2 * vr + (1 - beta2) * g2.mean(dim=-1))
        _assign(vc, beta2 * vc + (1 - beta2) * g2.mean(dim=-2))

    def factored_u(g32, vr, vc):
        rfac = torch.rsqrt(vr / torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps))
        return g32 * rfac[..., None] * torch.rsqrt(vc)[..., None, :]

    def apply(p, u, rms_u):
        u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
        p32 = p.float()
        newp = p32 - lr * u
        if weight_decay:
            newp = newp - lr * weight_decay * p32
        _assign(p, newp)

    def upd(g, v, p):
        if "vr" not in v:
            vv = v["v"]
            g32 = g.float()
            vv.copy_(beta2 * vv + (1 - beta2) * (g32.square() + eps))
            u = g32 * torch.rsqrt(vv)
            apply(p, u, torch.sqrt(u.square().mean() + eps))
            return p
        if isinstance(p, DTensor):  # whole leaves: the means reduce over shards
            g32 = g.float()
            moments_(g32, v["vr"], v["vc"])
            u = factored_u(g32, v["vr"], v["vc"])
            apply(p, u, torch.sqrt(u.square().sum() / p.numel() + eps))
            return p
        r, c = p.shape[-2:]
        lead = math.prod(p.shape[:-2])
        pv, gv = p.view(lead, r, c), g.reshape(lead, r, c)
        vr, vc = v["vr"].view(lead, r), v["vc"].view(lead, c)
        parts = list(chunk_slices(lead, r * c))
        # a slice at a time: the moments and the sum of u^2 first, then the
        # update, its u recomputed from the same moments (the same numbers)
        sq = torch.zeros((), dtype=torch.float32, device=p.device)
        for i, j in parts:
            g32 = gv[i:j].float()
            moments_(g32, vr[i:j], vc[i:j])
            sq += factored_u(g32, vr[i:j], vc[i:j]).square().sum()
            del g32  # not held through the second pass
        rms_u = torch.sqrt(sq / p.numel() + eps)
        for i, j in parts:
            apply(pv[i:j], factored_u(gv[i:j].float(), vr[i:j], vc[i:j]), rms_u)
        return p

    tree_map(upd, grads, state["v"], params)
    return params, {"v": state["v"], "count": count}


OPTIMIZERS = {
    "adamw": (adamw_init, adamw_update),
    "adafactor": (adafactor_init, adafactor_update),
}
