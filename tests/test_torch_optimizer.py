"""The port's optimizers against the JAX package's on the CPU: AdamW and
Adafactor updates over a few steps on the same trees (numpy from a seed:
stacked 3-D leaves, matrices, vectors, a leaf with a unit axis), with fp32
and bf16 parameters, weight decay on and off, and Adafactor's two-pass
slice-at-a-time path; plus the cases of ``tests/test_training_substrate.py``
(:29, :44, :52) on the port.

Tolerances: the port's arithmetic is the reference's expression for
expression.  AdamW's is elementwise and equals the reference bit for bit.
Adafactor's row and column means (``g².mean`` over an axis, and ``vr``'s
mean) are sums that XLA takes in another order, so its moments and
parameters differ by an fp32 ulp here and there (measured: 1 of 40
parameters by 6.3e-8 relative, 1 of 8 ``vr`` by 1.2e-7); they are held
within a few fp32 ulps (rtol 4e-7, atol 1e-12), and bf16 parameters within
one bf16 ulp (rtol 2**-8), where such an fp32 difference lands the other
side of a bf16 rounding tie."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.training.optimizer as jax_opt
import repro_torch.training.optimizer as opt

F32 = dict(rtol=4e-7, atol=1e-12)
BF16 = dict(rtol=2.0**-8, atol=1e-12)
EXACT = dict(rtol=0, atol=0)


def _trees(dtype, seed=0):
    """(numpy params, [numpy grads] x 3) with the leaf kinds the models have."""
    rng = np.random.default_rng(seed)
    shapes = {"stack": (3, 6, 10), "mat": (8, 5), "vec": (7,), "col": (4, 1)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    params["nested"] = {"w": rng.standard_normal((2, 4, 3)).astype(np.float32)}
    grads = [jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 1e-2).astype(np.float32),
                          params) for _ in range(3)]
    if dtype == "bfloat16":
        cast = lambda t: jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), t)
        params, grads = cast(params), [cast(g) for g in grads]
    return params, grads


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else
            (torch.from_numpy(np.asarray(v).view(np.int16).copy()).view(torch.bfloat16)
             if v.dtype.name == "bfloat16" else torch.from_numpy(np.array(v)))
            for k, v in tree.items()}


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _close(got, want, what, exact=False):
    want = np.asarray(want)
    tol = EXACT if exact else BF16 if want.dtype.name == "bfloat16" else F32
    assert str(got.dtype).removeprefix("torch.") == want.dtype.name, what
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32), err_msg=what, **tol)


def _run_both(name, dtype, steps=3, **kw):
    params, grads = _trees(dtype)
    jinit, jupd = jax_opt.OPTIMIZERS[name]
    tinit, tupd = opt.OPTIMIZERS[name]
    jp = jax.tree.map(jnp.asarray, params)
    js = jinit(jp)
    tp = _torch(params)
    ts = tinit(tp)
    for g in grads[:steps]:
        jp, js = jupd(jax.tree.map(jnp.asarray, g), js, jp, lr=1e-2, **kw)
        tp, ts = tupd(_torch(g), ts, tp, lr=1e-2, **kw)
    exact = name == "adamw"
    for k, v in _leaves(jax.tree.map(np.asarray, jp)).items():
        _close(_leaves(tp)[k], v, f"param {k}", exact)
    jst = _leaves(jax.tree.map(np.asarray, js))
    assert sorted(_leaves(ts)) == sorted(jst)
    for k, v in jst.items():
        _close(_leaves(ts)[k], v, f"state {k}", exact)
    return tp, ts


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weight_decay", [0.1, 0.0])
def test_adamw_update_equals_jax(dtype, weight_decay):
    _run_both("adamw", dtype, weight_decay=weight_decay)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adafactor_update_equals_jax(dtype, weight_decay):
    _run_both("adafactor", dtype, weight_decay=weight_decay)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adafactor_slice_at_a_time_equals_jax(dtype, monkeypatch):
    """With slices of 2 rows of a (6, 10) matrix (``_CHUNK`` = 120 elements)
    the stacked leaves take the two-pass path: the moments and the sum of
    u^2 slice by slice, then the update; the numbers stay the reference's."""
    monkeypatch.setattr(opt, "_CHUNK", 120)
    assert len(list(opt.chunk_slices(3, 60))) == 2
    _run_both("adafactor", dtype)


def test_adamw_slice_at_a_time_equals_jax(monkeypatch):
    monkeypatch.setattr(opt, "_CHUNK", 16)
    _run_both("adamw", "float32")


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_updates_are_in_place(name):
    params, grads = _trees("float32")
    init, update = opt.OPTIMIZERS[name]
    tp = _torch(params)
    ts = init(tp)
    before = {k: v.clone() for k, v in _leaves(tp).items()}
    moments = _leaves({k: v for k, v in ts.items() if k != "count"})
    tp2, ts2 = update(_torch(grads[0]), ts, tp, lr=1e-2)
    assert tp2 is tp
    for k, v in _leaves(tp).items():
        assert not torch.equal(v, before[k]), k
    for k, v in _leaves({k: v for k, v in ts2.items() if k != "count"}).items():
        assert v is moments[k], k
    assert int(ts2["count"]) == 1 and int(ts["count"]) == 0


# the cases of tests/test_training_substrate.py, on the port
def _quadratic_problem():
    target = {"w": torch.tensor([1.0, -2.0, 3.0]), "m": torch.ones((4, 5)) * 0.5}
    params = {k: torch.zeros_like(v) for k, v in target.items()}

    def loss(p):
        return sum(torch.sum(torch.square(p[k] - target[k])) for k in target)

    return params, loss


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_converges_on_quadratic(name):
    params, loss = _quadratic_problem()
    init, update = opt.OPTIMIZERS[name]
    state = init(params)
    l0 = float(loss(params))
    kw = {"weight_decay": 0.0} if name == "adamw" else {}
    for _ in range(200):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        grads = dict(zip(leaves, torch.autograd.grad(loss(leaves), list(leaves.values()))))
        params, state = update(grads, state, params, lr=5e-2, **kw)
    assert float(loss(params)) < l0 * 1e-2


def test_adamw_state_shapes_match_params():
    params = {"a": torch.ones((3, 4)), "b": {"c": torch.ones(7)}}
    st = opt.adamw_init(params)
    assert _leaves(st["mu"]).keys() == _leaves(params).keys()
    for m, p in zip(_leaves(st["mu"]).values(), _leaves(params).values()):
        assert m.shape == p.shape and m.dtype == torch.float32
    assert st["count"].dtype == torch.int32 and st["count"].shape == ()


def test_adafactor_factored_second_moment_is_small():
    params = {"w": torch.ones((128, 256))}
    st = opt.adafactor_init(params)
    leaf = st["v"]["w"]
    # factored: 128 + 256 numbers, not 128*256
    assert leaf["vr"].shape == (128,) and leaf["vc"].shape == (256,)


def test_optimizer_names_equal_jax():
    assert sorted(opt.OPTIMIZERS) == sorted(jax_opt.OPTIMIZERS)
