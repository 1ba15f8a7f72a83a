"""The multi-pod (2x16x16) ``train_4k`` dry run at one layer, for
musicgen-large, hymba-1.5b: status ok, and the per-device argument bytes the JAX
package's rules give the same cell (``multipod_reference``).  Without the
residual stream reduced over 'model' before each layer's second norm
(``transformer._residual``), DTensor reduce-scatters the attention's
partial output over the sequence there, and a weight-gradient product
meets a strided split (``_StridedShard``) on 'model' that its shard
propagation cannot follow on fake tensors.  The cells are split over files
so that each stays well inside a worker's time."""
import pytest

from multipod_reference import check_cell


@pytest.mark.parametrize("arch", ["musicgen-large", "hymba-1.5b"])
def test_multipod_train_4k_runs_at_one_layer(arch, monkeypatch):
    check_cell(arch, 1, monkeypatch)
