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
"""
from __future__ import annotations

import math

import torch

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
def adamw_init(params):
    zeros32 = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
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
        pf, gf, muf, nuf = p.view(-1), g.reshape(-1), mu.view(-1), nu.view(-1)
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
        z = lambda shape: torch.zeros(shape, dtype=torch.float32, device=p.device)
        if _factored(p.shape):
            return {"vr": z(p.shape[:-1]), "vc": z(p.shape[:-2] + p.shape[-1:])}
        return {"v": z(p.shape)}

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
        vr.copy_(beta2 * vr + (1 - beta2) * g2.mean(dim=-1))
        vc.copy_(beta2 * vc + (1 - beta2) * g2.mean(dim=-2))

    def factored_u(g32, vr, vc):
        rfac = torch.rsqrt(vr / torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps))
        return g32 * rfac[..., None] * torch.rsqrt(vc)[..., None, :]

    def apply(p, u, rms_u):
        u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
        p32 = p.float()
        newp = p32 - lr * u
        if weight_decay:
            newp = newp - lr * weight_decay * p32
        p.copy_(newp)

    def upd(g, v, p):
        if "vr" not in v:
            vv = v["v"]
            g32 = g.float()
            vv.copy_(beta2 * vv + (1 - beta2) * (g32.square() + eps))
            u = g32 * torch.rsqrt(vv)
            apply(p, u, torch.sqrt(u.square().mean() + eps))
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
