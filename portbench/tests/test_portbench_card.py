"""On the card: the tiny cells run through the CUDA kernels, traced and
not, and come out correct (skips without a card)."""
import pytest

from portbench.harness import run_cell

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("cell", ["tiny-kron.sweep", "tiny-cl.traverse"])
def test_tiny_cells_on_the_card(tiny_root, card, cell):
    for traced in (False, True):
        r = run_cell(tiny_root, cell, 2**33 + 3, 0.5, traced, card,
                     log=lambda msg: None)
        assert r["correct"], r["checks"]
        assert r["device"]["platform"] == "gpu"
        if traced:
            assert r["device"]["busy_s"] > 0
            assert r["breakdown"]["device_ops"]
