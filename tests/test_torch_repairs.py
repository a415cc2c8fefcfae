"""Two repairs of the port, each checked where it lives.

  * The speculative dispatch predicts the next frame's local-map search
    radius with the tracker's own schedule (`_search_mult`), so a subclass's
    schedule reaches the prediction too: for every state in which
    speculation may dispatch (tracking OK, any count of frames since a
    relocalisation, either base), the predicted radius is the one the next
    frame's decision uses, StereoInertialTracker's 1.0 tier included. That
    pipelined mode still equals sync mode bit for bit is
    test_torch_pipelined.py::test_pipelined_matches_sync.
  * No function defaults to the CPU: `vocabulary.train`,
    `pose_graph.essential_edges_from_map` and the lifetime runs take
    `device` as a required argument.
"""

import inspect

import numpy as np
import pytest
import torch

from orb_slam3_vio_fixes_tpu_torch import lifetime
from orb_slam3_vio_fixes_tpu_torch.frontend import inertial_tracking as it
from orb_slam3_vio_fixes_tpu_torch.frontend import tracking
from orb_slam3_vio_fixes_tpu_torch.imu import preintegration as pre
from orb_slam3_vio_fixes_tpu_torch.io import synthetic
from orb_slam3_vio_fixes_tpu_torch.ops import orb
from orb_slam3_vio_fixes_tpu_torch.optim import pose_graph
from orb_slam3_vio_fixes_tpu_torch.slam_map import map_state as ms
from orb_slam3_vio_fixes_tpu_torch.slam_map import vocabulary
from orb_slam3_vio_fixes_tpu_torch.utils.cameras import Camera

torch.set_num_threads(2)

CAM = Camera.pinhole(260.0, 260.0, 176.0, 120.0)
CFG = tracking.TrackerConfig(orb=orb.ORBConfig(n_features=400, n_levels=4),
                             map=ms.MapConfig(max_keyframes=32, max_landmarks=4096,
                                              max_features=400),
                             width=352, height=240)
OK = tracking.TrackState.OK


def _tracker(kind):
    if kind == "stereo":
        return tracking.StereoTracker(CAM, 52.0, CFG, device="cpu")
    calib = pre.ImuCalib.make(1.7e-4, 2e-3, 1.9e-5, 3e-3, 200.0, device="cpu")
    return it.StereoInertialTracker(CAM, 52.0, calib, CFG, device="cpu")


@pytest.mark.parametrize("base", [1.0, 1.5])
@pytest.mark.parametrize("kind", ["stereo", "stereo_inertial"])
def test_speculative_radius_is_the_next_decision(kind, base):
    tr = _tracker(kind)
    tr.th_local_base = base
    predicted = {}
    for since in (0, 1, 2, 3, 1000):
        tr.track_state, tr.frames_since_reloc = OK, since
        predicted[since] = tr._spec_search_th()
        tr.frames_since_reloc += 1          # the next frame's count, then its decision
        assert tr._local_search_th() == predicted[since], (kind, base, since)
    healthy = 1.0 if kind == "stereo_inertial" else base
    assert predicted == {0: 2.0, 1: healthy, 2: healthy, 3: healthy, 1000: healthy}


def test_spec_inputs_carry_the_predicted_radius():
    """The radius `_spec_inputs` hands the speculative step is the helper's,
    on a pipelined tracker with a frame in flight."""
    rng = np.random.default_rng(7)
    world = synthetic.make_world(rng, n_points=600, extent=7.0, depth_range=(2.5, 9.0))
    seq = synthetic.make_stereo_sequence(rng, n_frames=3, h=240, w=352, fx=260.0,
                                         baseline=0.2, world=world)
    tr = tracking.StereoTracker(CAM, 52.0, CFG, device="cpu")
    tr.pipelined = True
    for i in range(3):
        tr.process_stereo(seq.imgs_l[i], seq.imgs_r[i], seq.ts[i])
    assert tr._pending is not None and tr.track_state == OK
    for base in (1.0, 1.5):
        tr.th_local_base = base
        for since in (0, 1, 7):
            tr.frames_since_reloc = since
            assert tr._spec_inputs()[-1] == (2.0 if since == 0 else base)
    tr.flush()


@pytest.mark.parametrize("fn", [
    vocabulary.train, pose_graph.essential_edges_from_map, lifetime.marathon,
    lifetime.culling_run, lifetime.capacity_growth_run, lifetime.slot_reuse_run,
    lifetime.noise_run, lifetime.retrieval_at_capacity, lifetime.retrieval_grouped])
def test_device_is_required(fn):
    p = inspect.signature(fn).parameters["device"]
    assert p.default is inspect.Parameter.empty, fn.__name__


def test_train_without_device_raises():
    descs = np.random.default_rng(0).integers(0, 2**31, (40, 8)).astype(np.int32)
    with pytest.raises(TypeError):
        vocabulary.train(descs, branching=2, depth=2)
    with pytest.raises(TypeError):
        pose_graph.essential_edges_from_map(np.zeros((2, 3, 3)), np.zeros((2, 3)),
                                            np.ones(2, bool), np.array([-1, 0]),
                                            np.zeros((2, 2)), 4)
    v = vocabulary.train(descs, branching=2, depth=2, device="cpu")
    assert v.nodes.device.type == "cpu" and v.weights.device.type == "cpu"
