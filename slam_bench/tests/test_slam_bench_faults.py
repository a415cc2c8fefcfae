"""The timed path broken underneath a run, and `correct` comes out false
each time: a step that returns its state unchanged, half of a frame's
features left out, a K2 answer altered where it is produced, poses altered
where they are produced and, in the stereo-inertial cell, the IMU's
samples zeroed before the tracker reads them. (The cells run on one chip:
there is no exchange between chips to leave out.) On the CPU at the tiny
size, with its limits (tiny.py); on the card the IMU fault at the cell's
own size, on three seeds, its numbers printed (`pytest -m cuda -s`); the
other faults' readings there come from the truth put in the program's
place (`check.fault_numbers`, in the control runs)."""

import importlib
import json

import numpy as np
import pytest
import torch

from slam_bench import run, spec
from slam_bench.tests import tiny

SEED = 2**31 + 11
INERTIAL = ("ate_m", "kf_vel_err", "kf_bg_err")


def stale(orig):
    """The step runs, and returns the state it had at the window's start."""
    first = []

    def f(self, *a, **k):
        out = orig(self, *a, **k)
        if not first:
            first.append(out)
        return first[0]
    return f


def half_features(orig):
    def f(*a, **k):
        out = orig(*a, **k)
        valid = out.valid.clone()
        valid[::2] = False
        return out._replace(valid=valid)
    return f


def altered_k2(orig):
    def f(desc_q, desc_t, mask, cols):
        best_idx, *rest = orig(desc_q, desc_t, mask, cols)
        return (best_idx + 1, *rest)
    return f


def altered_pose(orig):
    """Every other pose moved 20 cm along the camera's x axis."""
    calls = []

    def f(self, *a, **k):
        R, t, state = orig(self, *a, **k)
        calls.append(1)
        return R, t + (0.2 if len(calls) % 2 else 0.0) * np.array([1.0, 0.0, 0.0]), state
    return f


def zeroed_imu(orig):
    """The frame's IMU samples reach the tracker as zeros (their times kept)."""
    def f(self, img_l, img_r, ts, imu=None):
        if imu is not None:
            imu = np.array(imu, copy=True)
            imu[:, :6] = 0.0
        return orig(self, img_l, img_r, ts, imu)
    return f


FAULTS = {
    "state_unchanged": ("system", "SLAMSystem.track_stereo", stale, ("ate_m",)),
    "half_the_features": ("frontend.tracking", "build_stereo_frame_impl", half_features,
                          ("feat_bad",)),
    "k2_answer_altered": ("ops.matching", "hamming_match", altered_k2, ("k2_bad",)),
    "pose_altered": ("system", "SLAMSystem.track_stereo", altered_pose, ("ate_m",)),
    "imu_zeroed": ("system", "SLAMSystem.track_stereo", zeroed_imu, INERTIAL),
}
CASES = [("stereo", f) for f in FAULTS if f != "imu_zeroed"] + [("si", "imu_zeroed"),
                                                                ("si", "pose_altered")]


def plant(monkeypatch, fault):
    """Plant `fault` once the warm-up is over: the window runs it."""
    module, attr, make, _ = FAULTS[fault]
    owner = importlib.import_module("orb_slam3_vio_fixes_tpu_torch." + module)
    *path, name = attr.split(".")
    for p in path:
        owner = getattr(owner, p)
    warm_up = run.Run.warm_up

    def broken_after_warm_up(self):
        warm_up(self)
        monkeypatch.setattr(owner, name, make(getattr(owner, name)))

    monkeypatch.setattr(run.Run, "warm_up", broken_after_warm_up)


SECONDS = {"stereo": 3.0, "si": 5.0}


@pytest.fixture(scope="module")
def sound(tmp_path_factory):
    out = {}
    for which in ("stereo", "si"):
        bench, cell = tiny.bench(which, tmp_path_factory.mktemp(which))
        out[which] = run.run_cell(bench, cell, SEED, SECONDS[which], False, device="cpu")
    return out


@pytest.mark.parametrize("which,fault", CASES)
def test_a_broken_timed_path_is_not_correct(which, fault, sound, tmp_path, monkeypatch):
    assert sound[which]["correct"] is True
    plant(monkeypatch, fault)
    # a broken path may run faster than the sound one
    bench, cell = tiny.bench(which, tmp_path, max_fps=40)
    res = run.run_cell(bench, cell, SEED, SECONDS[which], False, device="cpu")
    assert res["correct"] is False
    failed = [k for k in FAULTS[fault][3] if res["checks"][k]["value"] is None
              or res["checks"][k]["value"] > res["checks"][k]["limit"]]
    assert failed
    for k in failed:
        got, base = res["checks"][k]["value"], sound[which]["checks"][k]["value"]
        assert got is None or got > base


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [4100000001, 4100000002, 4100000003])
def test_imu_fault_on_the_card(seed, card, monkeypatch):
    plant(monkeypatch, "imu_zeroed")
    bench = spec.Bench(tiny.ROOT)
    res = run.run_cell(bench, "euroc_si.explore", seed, 20.0, False, device=card)
    print(json.dumps({"fault": "imu_zeroed", "seed": seed, "attempted": res["attempted"],
                      "failed": res["failed"],
                      "numbers": {k: c["value"] for k, c in res["checks"].items()}}))
    assert res["correct"] is False
