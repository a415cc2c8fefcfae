"""The mesh paths of the port's front end and facade: LoopCloser(mesh=...),
the inertial tracker's full-map VI BA over its closer's mesh (in
test_torch_inertial_hooks), Relocalizer(mesh=...) (in
test_torch_reloc_atlas) and SLAMSystem(mesh=...), on the CPU with
parallel.Mesh(["cpu"] * n).

Tolerances: a sharded loop correction within 2e-3 m / 1e-4 of the
unsharded one (test_vi_gba_sharded_parity_8_devices's pose bar) and
within test_torch_loop's bar against the truth; the facades within their
own test's bars (tracking OK, the relocalised centre within 0.1 m).
"""

import jax
import numpy as np
import pytest
import torch

from orb_slam3_vio_fixes_tpu_torch import system as sysm
from orb_slam3_vio_fixes_tpu_torch.frontend import loop_closing as tlc
from orb_slam3_vio_fixes_tpu_torch.frontend import tracking
from orb_slam3_vio_fixes_tpu_torch.io import synthetic
from orb_slam3_vio_fixes_tpu_torch.ops import orb
from orb_slam3_vio_fixes_tpu_torch.optim import vi_global_ba as tvg
from orb_slam3_vio_fixes_tpu_torch.parallel import Mesh, sharded_ba
from orb_slam3_vio_fixes_tpu_torch.slam_map import vocabulary as voc

from test_loop_closing import N_KF, _make_scenario
from test_torch_loop import TCAM, jax_sim3_draws, port_state, port_vocab
from test_torch_system import settings_path, seq, small_map, small_tracker_cfg  # noqa: F401

pytest_plugins = ["torch_jax_release"]
# every thread a test starts (shards, decoder, interface loops) ends with it
pytestmark = pytest.mark.usefixtures("threads_end")

torch.set_num_threads(2)


def calls_of(monkeypatch, owner, name):
    """Count the calls of owner.name (still made)."""
    real = getattr(owner, name)
    calls = []

    def wrapped(*a, **k):
        calls.append(name)
        return real(*a, **k)

    monkeypatch.setattr(owner, name, wrapped)
    return calls


def test_loop_closer_mesh_correction(monkeypatch):
    """tests/test_loop_closing.py's out-and-back map with the global BA on:
    the closer with a mesh corrects through distributed_global_ba, the
    draws shared with the unsharded closer (test_torch_loop.JaxDraws); the
    corrected poses agree and the revisit keyframe moves to within a
    quarter of its drift."""
    sc = _make_scenario()
    cfg = tlc.LoopConfig(min_gap_kfs=8, min_score=0.02, run_gba=True, n_consistency=1)
    gba = calls_of(monkeypatch, sharded_ba, "distributed_global_ba")
    out = {}
    for name, mesh in (("single", None), ("mesh", Mesh(["cpu"] * 2))):
        closer = tlc.LoopCloser(port_vocab(sc["vocab"]), TCAM, 16, np.ones(4, np.float32),
                                cfg=cfg, mesh=mesh, device="cpu")
        ts = port_state(sc["state"])
        for k in range(N_KF - 1):
            closer.add_keyframe(ts, k)
        jax_sim3_draws(monkeypatch, jax.random.PRNGKey(7), per_call=True)
        out[name] = closer.on_keyframe(ts, sc["kf_last"], N_KF)
    assert gba == ["distributed_global_ba"]
    (s1, r1), (s8, r8) = out["single"], out["mesh"]
    assert r1 is not None and r1.corrected and r8 == r1
    np.testing.assert_allclose(s8.kf_t.numpy(), s1.kf_t.numpy(), atol=2e-3)
    np.testing.assert_allclose(s8.kf_R.numpy(), s1.kf_R.numpy(), atol=1e-4)
    kf = sc["kf_last"]
    C_before = -sc["R_est"][kf].T @ sc["t_est"][kf]
    C_after = -s8.kf_R[kf].numpy().T @ s8.kf_t[kf].numpy()
    centre = sc["centers"][kf]
    assert np.linalg.norm(C_after - centre) < 0.25 * np.linalg.norm(C_before - centre)


def _vocab_of(img, n_features=400):
    img = torch.as_tensor(np.clip(np.rint(img), 0, 255).astype(np.float32))
    f0 = orb.extract_batch(img[None], orb.ORBConfig(n_features=n_features, n_levels=4))
    return voc.train(f0.desc[0][f0.valid[0]].numpy(), branching=8, depth=2, seed=0,
                     device="cpu")


def test_slam_system_mesh_stereo(settings_path, seq):  # noqa: F811
    """SLAMSystem(STEREO, mesh=Mesh(["cpu"] * 8, ("db",))): the closer and the
    relocaliser carry the mesh; after a blackout the facade relocalises
    through the sharded whole-map search (n_success_global), back at
    frame 6's pose."""
    mesh = Mesh(["cpu"] * 8, ("db",))
    slam = sysm.SLAMSystem(settings_path, sysm.Sensor.STEREO, vocab=_vocab_of(seq.imgs_l[0]),
                           map_cfg=small_map(), tracker_cfg=small_tracker_cfg(), mesh=mesh,
                           device="cpu")
    assert slam.loop_closer.mesh is mesh and slam.relocalizer.mesh is mesh
    for i in range(12):
        slam.track_stereo(seq.imgs_l[i], seq.imgs_r[i], seq.ts[i])
    assert slam.get_tracking_state() == tracking.TrackState.OK
    blank = np.zeros_like(seq.imgs_l[0])
    for j in range(3):
        slam.track_stereo(blank, blank, seq.ts[11] + 0.05 * (j + 1))
    assert slam.get_tracking_state() != tracking.TrackState.OK
    slam.track_stereo(seq.imgs_l[6], seq.imgs_r[6], seq.ts[11] + 0.2)
    assert slam.get_tracking_state() == tracking.TrackState.OK
    assert slam.relocalizer.n_success_global >= 1
    C = -slam.tracker.R.numpy().T @ slam.tracker.t.numpy()
    assert np.linalg.norm(C - seq.t_wc[6]) < 0.1


def test_slam_system_mesh_imu_stereo(tmp_path, monkeypatch):
    """SLAMSystem(IMU_STEREO, mesh=Mesh(["cpu"] * 2)) on
    test_imu_stereo_atlas_load_resets_inertial_state's scene: the IMU
    initialisation's full-map VI BA runs landmark-sharded over the closer's
    mesh (as the JAX tracker runs it), and tracking goes on OK with a finite
    map."""
    from test_torch_rgbd import IMU_YAML

    rng = np.random.default_rng(5)
    world = synthetic.make_world(rng, n_points=600, extent=7.0, depth_range=(2.5, 9.0))
    s = synthetic.make_stereo_inertial_sequence(rng, n_frames=24, h=240, w=352, fx=260.0,
                                                baseline=0.2, world=world, imu_hz=200.0,
                                                accel_amp=0.6)
    path = tmp_path / "imu_stereo.yaml"
    path.write_text(IMU_YAML)
    mesh = Mesh(["cpu"] * 2)
    sharded = calls_of(monkeypatch, tvg, "run_global_vi_ba_sharded")
    single = calls_of(monkeypatch, tvg, "run_global_vi_ba")
    slam = sysm.SLAMSystem(str(path), sysm.Sensor.IMU_STEREO, vocab=_vocab_of(s.imgs_l[0]),
                           map_cfg=small_map(), tracker_cfg=small_tracker_cfg(), mesh=mesh,
                           device="cpu")
    tr = slam.tracker
    assert tr.loop_closer.mesh is mesh
    tr.icfg = tr.icfg._replace(init_min_kfs=4, init_min_time=0.5)
    i = 0
    while not tr.imu_ready:
        imu = s.imu[i - 1] if i > 0 else np.zeros((0, 7), np.float32)
        slam.track_stereo(s.imgs_l[i], s.imgs_r[i], s.ts[i], imu)
        i += 1
        assert i < 20, "the IMU never initialised"
    for i in range(i, i + 3):
        slam.track_stereo(s.imgs_l[i], s.imgs_r[i], s.ts[i], s.imu[i - 1])
    assert sharded and not single
    assert slam.get_tracking_state() == tracking.TrackState.OK
    live = tr.state.lm_valid
    assert torch.isfinite(tr.state.lm_pos[live]).all()
    assert torch.isfinite(tr.state.kf_t[torch.as_tensor(tr.kf_order)]).all()
