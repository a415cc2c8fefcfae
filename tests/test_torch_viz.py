"""The port's offline drawers and viewer (orb_slam3_vio_fixes_tpu_torch/viz)
against the JAX package's: the twins of tests/test_viz.py.

Tolerances: draw_frame's array and status exactly equal to the reference's
on the same inputs; draw_map's summary (landmarks, keyframes, covisibility
edges) equal on tests/test_viz.py's toy state, converted to the port's
MapState; the viewer writes the same files.
"""

import os

import numpy as np
import pytest
import torch

from orb_slam3_vio_fixes_tpu import viz as jviz
from orb_slam3_vio_fixes_tpu_torch import convert
from orb_slam3_vio_fixes_tpu_torch import viz as tviz

from test_viz import _toy_state

torch.set_num_threads(2)


@pytest.mark.parametrize("seed", [0, 1])
def test_draw_frame_like_reference(seed):
    rng = np.random.default_rng(seed)
    gray = rng.uniform(-20, 280, (60, 80)).astype(np.float32)
    uv = rng.uniform(-10, 90, (40, 2))
    mask = rng.random(40) < 0.5
    got = tviz.draw_frame(gray, uv, mask, state="OK", n_kf=2, n_lm=16)
    ref = jviz.draw_frame(gray, uv, mask, state="OK", n_kf=2, n_lm=16)
    assert got.dtype == ref.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)
    assert tviz.draw_frame.last_status == jviz.draw_frame.last_status
    np.testing.assert_array_equal(tviz.draw_frame(gray, uv), jviz.draw_frame(gray, uv))


def test_draw_map_and_viewer_like_reference(tmp_path):
    jst = _toy_state()
    tst = convert.map_state_from_numpy(
        {f: np.array(getattr(jst, f)) for f in jst._fields}, "cpu")
    got = tviz.draw_map(tst, str(tmp_path / "map.png"))
    assert got == jviz.draw_map(jst, str(tmp_path / "jax_map.png"))
    assert got == {"n_landmarks": 16, "n_keyframes": 2, "n_covis_edges": 1}

    viewer = tviz.OfflineViewer(str(tmp_path / "viz"), every_n=2)
    gray = np.zeros((40, 50), np.float32)
    for i in range(4):
        p = viewer.update(i, gray, np.array([[5.0, 5.0]]), np.array([True]), "OK", 2, 16)
        assert (p is not None) == (i % 2 == 0)
    # a trajectory of tensors, as the port's trackers hold poses
    traj = [(0.0, torch.eye(3), torch.zeros(3)),
            (0.1, torch.eye(3), torch.tensor([0.1, 0.0, 0.0]))]
    out = viewer.finalize(map_state=tst, trajectory=traj)
    assert out["n_records"] == 4 and out["map"] == got and out["trajectory_png"]
    assert sorted(os.listdir(tmp_path / "viz")) == [
        "frame_000000.png", "frame_000002.png", "map.png", "trajectory.png"]
