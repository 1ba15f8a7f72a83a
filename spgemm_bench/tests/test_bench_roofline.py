"""The roofline counts come from the structures alone."""
import numpy as np
import scipy.sparse as sp

from spgemm_bench import roofline
from spgemm_bench.instance import canonical, symbolic_product


def test_hand_counted_three_by_three():
    # A = [[x, x, .], [., x, .], [x, ., x]], B = [[x, ., .], [x, x, .], [., ., x]]
    a = canonical(sp.csr_matrix(np.array([[1, 1, 0], [0, 1, 0], [1, 0, 1]])))
    b = canonical(sp.csr_matrix(np.array([[1, 0, 0], [1, 1, 0], [0, 0, 1]])))
    c = symbolic_product(a, b)  # [[x, x, .], [x, x, .], [x, ., x]]
    assert c.nnz == 6
    got = roofline.counts(a, b, c)
    # nnz(A[:, k]) * nnz(B[k, :]) over k: 2 * 1 + 2 * 2 + 1 * 1 = 7 multiply-adds
    assert got.flops == 14
    # A: 5 values, 4 row pointers, 5 indices; B: 4, 4, 4; C: 6 values
    assert got.k1_bytes == 4 * (5 + 4 + 5) + 4 * (4 + 4 + 4) + 4 * 6
    assert got.product_bytes == 4 * (5 + 4 + 5) + 4 * (4 + 4 + 4) + 4 * 9


def test_least_seconds_is_the_larger_bound_and_none_off_the_table():
    kind = "NVIDIA H100 80GB HBM3"
    assert roofline.least_seconds(0, 3_350_000, kind) == 1e-6
    assert roofline.least_seconds(67_000_000, 0, kind) == 1e-6
    assert roofline.least_seconds(1, 1, "some other card") is None


def test_counts_are_the_same_for_two_models_plans_of_one_instance():
    """Planned monoC and rowwise hand back one instance; its counts do not
    depend on the plan."""
    import repro_torch

    from spgemm_bench.spec import Spec

    gen = Spec().generator("amg")
    inst = gen.build({"n": 6, "aggregate": 3, "smoother_degree": 1})
    s = inst.structures
    ours = roofline.instance_counts(inst)["AP"]
    for model in ("monoC", "rowwise"):
        planned = repro_torch.plan(s["A"], s["P"], p=2, model=model, seed=0)
        theirs = roofline.counts(planned.instance.a.csr, planned.instance.b.csr,
                                 planned.instance.c.csr)
        assert theirs == ours
    assert ours.flops == 2 * planned.instance.n_mult
