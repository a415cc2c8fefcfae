"""The port's monocular path against the JAX package: build_mono_frame,
search_for_initialization, create_initial_mono_map, and the twin of
tests/test_e2e_mono.py (352x240, 400 features, 4 levels).

Tolerances:
- build_mono_frame on the JAX extraction's own features: uv, octave, angle,
  desc and valid exact, ur = depth = -1; the extraction runs on a one-image
  (B = 1) atlas, and the port's own (plain K1) extraction gives a full
  frame of the same layout;
- search_for_initialization on the same two frames: the match indices and
  count exact (integer Hamming distances, float32 radius tests computed
  alike);
- create_initial_mono_map from the same two-view result: the keyframe
  bindings, landmark count and validity exact, landmark positions, normals,
  distances and the scaled translation within 1e-5 (float32);
- the e2e twin (26 frames): both trackers end OK with >= 3 keyframes, the
  port's scale-aligned ATE < 0.10 m (the JAX test's bar) and within 0.02 m
  of the JAX tracker's on the same frames.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_vio_fixes_tpu.evaluation import ate as jate
from orb_slam3_vio_fixes_tpu.frontend import frame as jframe
from orb_slam3_vio_fixes_tpu.frontend import mono_tracking as jmono
from orb_slam3_vio_fixes_tpu.frontend import tracking as jtr
from orb_slam3_vio_fixes_tpu.io import synthetic as jsyn
from orb_slam3_vio_fixes_tpu.ops import orb as jorb
from orb_slam3_vio_fixes_tpu.ops import twoview as jtv
from orb_slam3_vio_fixes_tpu.slam_map import map_state as jms
from orb_slam3_vio_fixes_tpu.utils.cameras import Camera as JCamera
from orb_slam3_vio_fixes_tpu_torch.frontend import frame as tframe
from orb_slam3_vio_fixes_tpu_torch.frontend import mono_tracking as tmono
from orb_slam3_vio_fixes_tpu_torch.frontend import tracking as ttr
from orb_slam3_vio_fixes_tpu_torch.ops import orb as torb
from orb_slam3_vio_fixes_tpu_torch.utils.cameras import Camera as TCamera

from test_torch_loop import port_state
from test_torch_slice import port_cfg

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def seq():
    """tests/test_e2e_mono.py's sequence (the JAX generator)."""
    rng = np.random.default_rng(7)
    world = jsyn.make_world(rng, n_points=600, extent=7.0, depth_range=(2.5, 9.0))
    return jsyn.make_stereo_sequence(rng, n_frames=26, h=240, w=352, fx=260.0,
                                     baseline=0.2, world=world, speed=(0.9, 0.0, 0.15),
                                     yaw_rate=0.05)


def jax_cfg(seq):
    """tests/test_e2e_mono.py's configuration."""
    return jtr.TrackerConfig(
        orb=jorb.ORBConfig(n_features=400, n_levels=4),
        map=jms.MapConfig(max_keyframes=32, max_landmarks=4096, max_features=400),
        width=seq.imgs_l.shape[2], height=seq.imgs_l.shape[1], max_local_lm=1024,
        ba_window=6, ba_fixed=2, new_lm_budget=256, max_frames_between_kf=6)


def cams(seq):
    K = seq.K
    c = (K[0, 0], K[1, 1], K[0, 2], K[1, 2])
    return JCamera.pinhole(*c), TCamera.pinhole(*c)


def u8(img):
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def port_frame(jf) -> tframe.FrameData:
    return tframe.FrameData(*(torch.from_numpy(
        np.array(a).view(np.int32) if np.asarray(a).dtype == np.uint32 else np.array(a))
        for a in jf))


@pytest.fixture(scope="module")
def jax_frames(seq):
    cfg = jax_cfg(seq)
    return [jframe.build_mono_frame(jnp.asarray(u8(seq.imgs_l[i])), jnp.float32(seq.ts[i]),
                                    cfg.orb) for i in (0, 3)]


def test_build_mono_frame_matches_reference(seq, jax_frames, monkeypatch):
    img = u8(seq.imgs_l[0])
    cfg = jax_cfg(seq)
    ref = jax_frames[0]
    jf = jorb.extract(jnp.asarray(img, jnp.float32), cfg.orb)
    seen = []

    def jax_features(imgs, c):
        seen.append(tuple(imgs.shape))
        return torb.Features(*(torch.from_numpy(
            np.array(a).view(np.int32) if np.asarray(a).dtype == np.uint32
            else np.array(a))[None] for a in jf))

    tcfg = port_cfg(cfg).orb
    with monkeypatch.context() as m:
        m.setattr(torb, "extract_batch", jax_features)
        got = tframe.build_mono_frame(torch.from_numpy(img), torch.tensor(seq.ts[0]), tcfg)
    assert seen == [(1, 240, 352)]
    for f in ("uv", "octave", "angle", "desc", "valid"):
        r = np.asarray(getattr(ref, f))
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      r.view(np.int32) if r.dtype == np.uint32 else r,
                                      err_msg=f)
    assert (got.ur == -1).all() and (got.depth == -1).all()

    # the tracker's own path: the plain K1 on the CPU
    tr = tmono.MonocularTracker(cams(seq)[1], port_cfg(cfg), device="cpu")
    fr = tframe.build_mono_frame(tr._upload_image(seq.imgs_l[0]), tr._ts(seq.ts[0]), tcfg)
    assert fr.uv.shape == (400, 2) and int(fr.valid.sum()) >= 300
    assert (fr.ur == -1).all() and (fr.depth == -1).all()


def test_search_for_initialization_matches_reference(jax_frames):
    jidx, jn = jmono.search_for_initialization(*jax_frames, jnp.float32(100.0))
    idx, n = tmono.search_for_initialization(*(port_frame(f) for f in jax_frames), 100.0)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert int(n) == int(jn) >= 100


def test_create_initial_mono_map_matches_reference(seq, jax_frames):
    jcam, _ = cams(seq)
    cfg = jax_cfg(seq)
    ref, cur = jax_frames
    jidx, _ = jmono.search_for_initialization(ref, cur, jnp.float32(100.0))
    N = cur.uv.shape[0]
    res = jtv.reconstruct(jax.random.PRNGKey(1), ref.uv, cur.uv[jnp.clip(jidx, 0, N - 1)],
                          jidx >= 0, jcam)
    assert bool(res.success)
    tstate = port_state(jms.empty(cfg.map))
    jstate, jn, jobs1, _, jt1 = jmono.create_initial_mono_map(
        jms.empty(cfg.map), ref, cur, jidx, res.R, res.t, res.points, res.good, jcam, cfg)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    tstate, n, obs1, _, t1 = tmono.create_initial_mono_map(
        tstate, port_frame(ref), port_frame(cur), t(jidx), t(res.R), t(res.t),
        t(res.points), t(res.good), port_cfg(cfg))
    assert int(n) == int(jn) > 50
    np.testing.assert_array_equal(obs1.numpy(), np.asarray(jobs1))
    np.testing.assert_allclose(t1.numpy(), np.asarray(jt1), atol=1e-5)
    for f in ("kf_obs", "kf_valid", "kf_prev", "lm_valid", "lm_first_kf"):
        np.testing.assert_array_equal(getattr(tstate, f).numpy(),
                                      np.asarray(getattr(jstate, f)), err_msg=f)
    for f in ("kf_R", "kf_t", "lm_pos", "lm_normal", "lm_mindist", "lm_maxdist"):
        np.testing.assert_allclose(getattr(tstate, f).numpy(), np.asarray(getattr(jstate, f)),
                                   atol=1e-5, rtol=1e-5, err_msg=f)


def _scaled_ate(traj, seq):
    est_ts = np.array([x[0] for x in traj])
    est_pos = np.array([-x[1].T @ x[2] for x in traj])
    return jate.ate_rmse(seq.ts, seq.t_wc, est_ts, est_pos, with_scale=True)


def test_mono_tracking_ate_like_reference(seq):
    jcam, tcam = cams(seq)
    cfg = jax_cfg(seq)
    jt = jmono.MonocularTracker(jcam, cfg)
    tt = tmono.MonocularTracker(tcam, port_cfg(cfg), device="cpu")
    for i in range(seq.imgs_l.shape[0]):
        jt.process_mono(seq.imgs_l[i], seq.ts[i])
        tt.process_mono(seq.imgs_l[i], seq.ts[i])
    assert jt.track_state == tt.track_state == ttr.TrackState.OK
    assert tt.n_kf >= 3 and jt.n_kf >= 3
    ref, _, _ = _scaled_ate(jt.trajectory, seq)
    rmse, _, n = _scaled_ate(tt.trajectory, seq)
    assert n == len(seq.ts)
    assert rmse < 0.10, f"mono ATE {rmse:.3f} m too large"
    assert abs(rmse - ref) < 0.02, (rmse, ref)


def jax_config_of(cfg):
    """The JAX TrackerConfig with a port TrackerConfig's field values."""
    fields = cfg._asdict()
    fields["orb"] = jorb.ORBConfig(**cfg.orb._asdict())
    fields["map"] = jms.MapConfig(**cfg.map._asdict())
    return jtr.TrackerConfig(**fields)


@pytest.mark.slow
def test_jax_mono_reference_at_full_width():
    """Where chip_smoke.JAX_MONO_ATE_M comes from: the JAX package's
    MonocularTracker on phase 16's frames (the bench scene's 80 left images
    at 752x480, the bench's tracker configuration), scored as phase 16 does,
    on the CPU. Several minutes."""
    import chip_smoke

    seq = chip_smoke.make_sequence()
    K = seq.K
    jt = jmono.MonocularTracker(JCamera.pinhole(K[0, 0], K[1, 1], K[0, 2], K[1, 2]),
                                jax_config_of(chip_smoke.tracker_config(seq)))
    for i in range(seq.imgs_l.shape[0]):
        jt.process_mono(seq.imgs_l[i], seq.ts[i])
    _, rmse, scale, n = chip_smoke.mono_scores(seq.ts, seq.t_wc, jt.trajectory)
    jax.clear_caches()
    print(f"jax mono at 752x480: state={jt.track_state} keyframes={len(jt.kf_order)} "
          f"ate_rmse_m={rmse!r} horn_scale={scale!r} frames={n}")
    assert jt.track_state == "OK" and n == seq.imgs_l.shape[0]
    assert abs(rmse - chip_smoke.JAX_MONO_ATE_M) < 1e-6, rmse
