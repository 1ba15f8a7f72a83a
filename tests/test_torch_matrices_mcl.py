"""The port's MCL generator (``core/matrices.py:scale_free_graph``) builds
networkx's Barabási–Albert graphs without networkx: the same edges at the
graph sizes the MCL presets use, the same instance structures as the JAX
package's (which calls networkx) for every MCL preset, and the same planned
words for a monoC plan of one of them.  Every comparison is exact."""
import numpy as np
import pytest
import scipy.sparse as sp

import repro
import repro_torch
from repro.core import matrices as jax_matrices
from repro_torch.core import matrices

# (n, m) of the MCL presets: dip, facebook and dblp at scale 0.2; dip and biogrid11 at 1
BA_SIZES = [(1000, 4), (5000, 4), (800, 22), (2400, 2), (5800, 11)]
MCL_NAMES = ["facebook", "dip", "wiphi", "biogrid11", "enron", "dblp", "roadnetca"]


def _same_structure(got, want):
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)


@pytest.mark.parametrize("n,m", BA_SIZES)
def test_scale_free_graph_is_networkx_barabasi_albert(n, m):
    nx = pytest.importorskip("networkx")
    g = nx.barabasi_albert_graph(n, m, seed=0)
    want = nx.to_scipy_sparse_array(g, format="csr", dtype=np.int8)
    want = sp.csr_matrix(want + sp.identity(n, dtype=np.int8, format="csr"))
    want.sort_indices()
    got = matrices.scale_free_graph(n, m, seed=0)
    _same_structure(got, want)
    assert got.nnz == 2 * g.number_of_edges() + n


@pytest.mark.parametrize("name", MCL_NAMES)
def test_mcl_instance_structure_equals_jax(name):
    got, want = matrices.mcl_instance(name, 0.2), jax_matrices.mcl_instance(name, 0.2)
    assert got.name == want.name
    _same_structure(got.a, want.a)
    _same_structure(got.b, want.b)
    _same_structure(got.c, want.c)


def test_scale_free_graph_refuses_what_networkx_refuses():
    for n, m in ((10, 0), (4, 4)):
        with pytest.raises(ValueError, match="1 <= m < n"):
            matrices.scale_free_graph(n, m)


def test_monoC_plan_of_mcl_dip_equals_jax():
    got = repro_torch.plan(matrices.mcl_instance("dip", 0.2), p=4, model="monoC").cost_report()
    want = repro.plan(jax_matrices.mcl_instance("dip", 0.2), p=4, model="monoC").cost_report()
    for key in ("predicted_words", "planned_words", "padded_words", "predicted_max_part"):
        assert got[key] == want[key], key
    assert got["planned_words"] == got["predicted_words"]
