"""The benchmark's frozen generators give the port's structures, bit for bit."""
import numpy as np
import pytest
import scipy.sparse as sp

from spgemm_bench.spec import Spec


def _same(ours, theirs):
    assert ours.shape == theirs.shape
    assert np.array_equal(ours.indptr, theirs.indptr)
    assert np.array_equal(ours.indices, theirs.indices)


@pytest.mark.parametrize("n", [6, 9, 12])
def test_amg_structures_equal_the_port(n):
    from repro_torch.core import matrices

    gen = Spec().generator("amg")
    inst = gen.build({"n": n, "aggregate": 3, "smoother_degree": 1})
    ap, ptap = matrices.amg_instances(n)
    s = inst.structures
    _same(s["A"], ap.a.csr)
    _same(s["P"], ap.b.csr)
    _same(s["AP"], ap.c.csr)
    _same(s["PT"], ptap.a.csr)
    _same(s["PTAP"], ptap.c.csr)


def test_amg_degree_two_prolongator_equals_the_port():
    from repro_torch.core import matrices

    gen = Spec().generator("amg")
    a = gen.stencil27(6)
    ours = gen.smoothed_prolongator(a, gen.tentative_prolongator(6, 3), 2)
    theirs = matrices.smoothed_prolongator(
        matrices.stencil27(6), matrices.tentative_prolongator(6, 3), degree=2)
    _same(ours, theirs.csr)


@pytest.mark.parametrize("scale", [0.05, 1.0])
def test_lp_structures_equal_the_port(scale):
    """At scale 1 these are the lp-pds100 configuration's own structures."""
    from repro_torch.core import matrices

    spec = Spec()
    cfg = spec.config("lp-pds100")
    cfg = {**cfg, "rows": int(cfg["rows"] * scale), "cols": int(cfg["cols"] * scale)}
    inst = spec.generator("lp").build(cfg)
    theirs = matrices.lp_instance("pds100", scale=scale, seed=cfg["structure_seed"])
    _same(inst.structures["A"], theirs.a.csr)
    _same(inst.structures["DAT"], theirs.b.csr)
    _same(inst.structures["ADAT"], theirs.c.csr)


def test_value_sets_follow_the_structures():
    """P^T's values are P's moved to P^T's order; D A^T's row k is A^T's
    scaled by D's k-th entry, positive."""
    import torch

    spec = Spec()
    gen = spec.generator("amg")
    inst = gen.build({"n": 6, "aggregate": 3, "smoother_degree": 1})
    v = gen.values({}, inst, 2, torch.Generator().manual_seed(3), torch.device("cpu"))[1]
    p = inst.structures["P"].astype(np.float64)
    p.data = v["P"].double().numpy()
    pt = inst.structures["PT"].astype(np.float64)
    pt.data = v["PT"].double().numpy()
    assert (abs(p.T - pt)).max() == 0

    cfg = {**spec.config("lp-pds100"), "rows": 60, "cols": 200, "blocks": 4}
    lp = spec.generator("lp")
    inst = lp.build(cfg)
    v = lp.values(cfg, inst, 3, torch.Generator().manual_seed(4), torch.device("cpu"))
    a = inst.structures["A"].astype(np.float64)
    a.data = v[2]["A"].double().numpy()
    at = sp.csr_matrix(a.T)
    at.sort_indices()
    assert np.array_equal(at.indices, inst.structures["DAT"].indices)
    ratio = v[2]["DAT"].double().numpy() / at.data  # D's k-th entry on row k
    rows = np.repeat(np.arange(at.shape[0]), np.diff(at.indptr))
    per_row = np.zeros(at.shape[0])
    per_row[rows] = ratio
    np.testing.assert_allclose(ratio, per_row[rows], rtol=1e-6)
    assert (ratio > 0).all()
