"""The multi-pod (2x16x16) ``train_4k`` dry run at one layer, for
qwen3-moe-235b-a22b, internlm2-1.8b, phi3-mini-3.8b: status ok, and the per-device argument bytes the JAX
package's rules give the same cell (``multipod_reference``).  Without the
residual stream reduced over 'model' before each layer's second norm
(``transformer._residual``), DTensor reduce-scatters the attention's
partial output over the sequence there, and a weight-gradient product
meets a strided split (``_StridedShard``) on 'model' that its shard
propagation cannot follow on fake tensors.  The cells are split over files
so that each stays well inside a worker's time."""
import json

import pytest

from multipod_reference import check_cell
from repro_torch.launch import dryrun


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "internlm2-1.8b", "phi3-mini-3.8b"])
def test_multipod_train_4k_runs_at_one_layer(arch, monkeypatch):
    check_cell(arch, 1, monkeypatch)


def test_layers_option_cuts_the_depth(tmp_path):
    """``--layers N`` runs the cell at N layers and names its record ``_LN``."""
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "internlm2-1.8b", "--shape", "decode_32k", "--layers", "1",
                     "--out", str(tmp_path)])
    assert done.value.code == 0
    rec = json.loads((tmp_path / "internlm2-1.8b_decode_32k_16x16_L1.json").read_text())
    assert rec["status"] == "ok" and rec["n_layers"] == 1 and rec["n_devices"] == 256
