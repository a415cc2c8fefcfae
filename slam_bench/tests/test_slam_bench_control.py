"""The control: each stage's reference in the program's place at the next
lower precision (4-bit images and descriptor bytes, bfloat16 poses,
velocities and biases), on the inputs a run recorded, comes out as not
correct. On the CPU at the tiny size; on the card at the cell's own size
and load, on three seeds, with the program's and the control's numbers and
the readings of the faults planted in the truth printed (`pytest -m cuda
-s`)."""

import json

import pytest
import torch

from slam_bench import run, spec
from slam_bench.tests import tiny


@pytest.mark.parametrize("which", ["stereo", "si"])
def test_control_is_not_correct_on_the_cpu(which, tmp_path):
    bench, cell = tiny.bench(which, tmp_path)
    res = run.run_cell(bench, cell, 2**31 + 21, 3.0 if which == "stereo" else 5.0, False,
                       device="cpu", control=True)
    assert res["correct"] is False
    # the faults planted in the truth fail the trajectory's numbers
    for fault in res["faults"].values():
        assert fault["ate_m"] > res["checks"]["ate_m"]["limit"]
    for k in ("atlas_err", "k1_bad", "feat_bad", "k2_bad"):
        assert res["checks"][k]["value"] > res["checks"][k]["limit"], k
    for k in ("atlas_err", "k1_bad", "feat_bad", "k2_bad"):
        assert res["program"][k] == 0, k


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["euroc_si.explore", "euroc_stereo.explore"])
@pytest.mark.parametrize("seed", [4000000001, 4000000002, 4000000003])
def test_control_is_not_correct_on_the_card(cell, seed, card):
    bench = spec.Bench(tiny.ROOT)
    seconds = float(bench.data["run_seconds"])
    res = run.run_cell(bench, cell, seed, seconds, False, device=card, control=True)
    print(json.dumps({"cell": cell, "seed": seed, "program": res["program"],
                      "control": {k: c["value"] for k, c in res["checks"].items()},
                      "faults": res["faults"]}))
    assert res["correct"] is False
