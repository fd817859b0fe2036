"""On the card, at a cell's own size: a run is correct, and the control
(the reference in bfloat16 in the program's place) is not correct on three
seeds. Run there with

    python -m pytest benchmark/tests/test_card.py -m cuda -q -p no:cacheprovider -n 0
"""

import pytest
import torch

from benchmark import check, control, harness, run


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_a_run_of_the_main_cell_is_correct():
    _need_card()
    res = run.execute("orbit10kf.reconstruct", 2**31 + 101, 0.0, False)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["memory_peak_bytes"] > 0


@pytest.mark.cuda
def test_the_control_is_not_correct_at_the_cells_size():
    _need_card()
    limits = harness.load_cell("orbit10kf.reconstruct").config["limits"]
    for r in control.readings("orbit10kf.reconstruct", [2**31 + 103, 2**31 + 107, 2**31 + 109]):
        assert all(ok for _, _, ok in check.judge(r["sound"], limits).values())
        assert not all(ok for _, _, ok in check.judge(r["control"], limits).values())
