"""The float64 reference equals scipy's dense product; the comparison reads
errors, entries outside the structure and wrong shapes."""
import math

import numpy as np
import scipy.sparse as sp
import torch

from spgemm_bench import judge, reference
from spgemm_bench.instance import Instance, Product, canonical, symbolic_product


def _instance(seed=0, n=7):
    rng = np.random.default_rng(seed)
    a = canonical(sp.random(n, n + 2, density=0.3, random_state=rng) != 0)
    b = canonical(sp.random(n + 2, n - 1, density=0.3, random_state=rng) != 0)
    c = symbolic_product(a, b)
    d = canonical(sp.random(n - 1, n, density=0.4, random_state=rng) != 0)
    return Instance({"A": a, "B": b, "AB": c, "D": d, "ABD": symbolic_product(c, d)},
                    [Product("AB", "A", "B"), Product("ABD", "AB", "D")], ("A", "B", "D"))


def _values(inst, seed=1):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(inst.structures[k].nnz).astype(np.float32)
            for k in inst.base}


def _dense(s, v):
    m = np.zeros(s.shape)
    rows = np.repeat(np.arange(s.shape[0]), np.diff(s.indptr))
    m[rows, s.indices] = v
    return m


def test_reference_equals_dense_products_through_the_chain():
    inst = _instance()
    vals = _values(inst)
    out = reference.products(inst, vals)
    s = inst.structures
    ab = _dense(s["A"], vals["A"]) @ _dense(s["B"], vals["B"])
    abd = ab @ _dense(s["D"], vals["D"])
    np.testing.assert_allclose(out["AB"][0].toarray(), ab, rtol=1e-14, atol=1e-14)
    np.testing.assert_allclose(out["ABD"][0].toarray(), abd, rtol=1e-13, atol=1e-13)
    mag_ab = abs(_dense(s["A"], vals["A"])) @ abs(_dense(s["B"], vals["B"]))
    np.testing.assert_allclose(out["AB"][1].toarray(), mag_ab, rtol=1e-14)
    np.testing.assert_allclose(out["ABD"][1].toarray(), mag_ab @ abs(_dense(s["D"], vals["D"])),
                               rtol=1e-13)


def test_compare_reads_rounding_errors_strays_and_shapes():
    inst = _instance(2)
    vals = _values(inst, 3)
    ref, mag = reference.products(inst, vals)["AB"]
    s = inst.structures["AB"]
    record = judge.Recorder(inst)

    def compare(c):
        return judge.compare(record({"AB": c})["AB"], ref, mag, s)

    exact = torch.from_numpy(ref.toarray())
    assert compare(exact) == (0.0, 0)
    err, stray = compare(exact.float())
    assert 0 < err < 2**-23 and stray == 0
    off = exact.clone()
    rows, cols = np.nonzero(s.toarray() == 0)
    off[rows[0], cols[0]] = 1e-30
    assert compare(off)[1] == 1
    bent = exact.clone()
    r, c = record.entries("AB", "cpu")
    bent[r[0], c[0]] += 1e-3 * mag.data[0]
    assert abs(compare(bent)[0] - 1e-3) < 1e-9
    bent[r[1], c[1]] = float("nan")
    assert compare(bent)[0] == math.inf
    assert record({"AB": exact[:-1]})["AB"] is None
    assert judge.compare(None, ref, mag, s)[0] == math.inf


def test_record_keeps_only_the_entries_and_the_nonzero_count():
    inst = _instance(6)
    vals = _values(inst, 7)
    ref, _ = reference.products(inst, vals)["AB"]
    c = torch.from_numpy(ref.toarray()).float()
    at, nonzero = judge.Recorder(inst)({"AB": c})["AB"]
    s = inst.structures["AB"]
    assert at.shape == (s.nnz,) and int(nonzero) == int(torch.count_nonzero(c))
    np.testing.assert_array_equal(at.numpy(), c.numpy()[s.nonzero()])


def test_an_entry_with_no_nonzero_term_has_to_be_exact():
    inst = _instance(8)
    vals = _values(inst, 9)
    vals["A"][:] = 0.0
    ref, mag = reference.products(inst, vals)["AB"]
    s = inst.structures["AB"]
    record = judge.Recorder(inst)
    zero = torch.zeros(s.shape)
    assert judge.compare(record({"AB": zero})["AB"], ref, mag, s) == (0.0, 0)
    zero[s.nonzero()[0][0], s.nonzero()[1][0]] = 1e-30
    assert judge.compare(record({"AB": zero})["AB"], ref, mag, s)[0] == math.inf


def test_judge_holds_every_product_to_its_limit():
    inst = _instance(4)
    vals = _values(inst, 5)
    refs = reference.products(inst, vals)
    outs = {k: torch.from_numpy(v[0].toarray()).float() for k, v in refs.items()}
    record = judge.Recorder(inst)
    checks = judge.judge(inst, [(vals, record(outs))], {"AB": 1e-6, "ABD": 1e-6})
    assert set(checks) == {"err.AB", "stray.AB", "err.ABD", "stray.ABD"}
    assert judge.passed(checks)
    outs["ABD"] = outs["ABD"] * (1 + 1e-4)
    assert not judge.passed(judge.judge(inst, [(vals, record(outs))],
                                        {"AB": 1e-6, "ABD": 1e-6}))
