"""Both small cells end to end on a CUDA card, the kernels launched
(``pytest -m cuda bench/tests`` on a machine with one); here they skip."""
import _bench_path  # noqa: F401
import pytest
import torch
from _bench_cells import lm_cell, rar_cell, run_cell


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [rar_cell, lm_cell])
def test_small_cell_on_the_card(card, cell):
    out = run_cell(cell(), 2_147_483_701, steps=2, trace=1, device=card)
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0
