"""Parity of the port's map state and keyframe-rate mapping with the JAX
package: keyframe creation with stereo spawning, triangulation against a
neighbour, duplicate fusion, the map queries, culling, excision, growth and
the local-BA stage, each started from the same JAX state (converted with
orb_slam3_vio_fixes_tpu_torch.convert) on two frames of the test_e2e_stereo
scene.

Tolerances: integer and boolean fields exact; float fields within 1e-4
(float32 geometry in another operation order); local BA poses and points
within 1e-3 after 2 x 3 LM steps.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_vio_fixes_tpu.frontend import frame as jframe
from orb_slam3_vio_fixes_tpu.frontend import local_mapping as jlm
from orb_slam3_vio_fixes_tpu.frontend import tracking as jtr
from orb_slam3_vio_fixes_tpu.io import synthetic as jsyn
from orb_slam3_vio_fixes_tpu.ops import matching as jmatch
from orb_slam3_vio_fixes_tpu.ops import orb as jorb
from orb_slam3_vio_fixes_tpu.slam_map import map_state as jms
from orb_slam3_vio_fixes_tpu.utils.cameras import Camera as JCamera
from orb_slam3_vio_fixes_tpu_torch import convert
from orb_slam3_vio_fixes_tpu_torch.frontend import local_mapping as tlm
from orb_slam3_vio_fixes_tpu_torch.frontend import tracking as ttr
from orb_slam3_vio_fixes_tpu_torch.ops import orb as torb
from orb_slam3_vio_fixes_tpu_torch.slam_map import map_state as tms
from orb_slam3_vio_fixes_tpu_torch.utils.cameras import Camera as TCamera

torch.set_num_threads(2)


H, W, FX, B = 240, 352, 260.0, 0.2
BF = FX * B
JCAM = JCamera.pinhole(FX, FX, W / 2, H / 2)
TCAM = TCamera.pinhole(FX, FX, W / 2, H / 2)
MAPC = dict(max_keyframes=8, max_landmarks=2048, max_features=400)
JCFG = jtr.TrackerConfig(orb=jorb.ORBConfig(n_features=400, n_levels=4),
                         map=jms.MapConfig(**MAPC), width=W, height=H,
                         max_local_lm=1024, ba_window=6, ba_fixed=2,
                         new_lm_budget=256, max_frames_between_kf=6)
TCFG = ttr.TrackerConfig(orb=torb.ORBConfig(n_features=400, n_levels=4),
                         map=tms.MapConfig(**MAPC), width=W, height=H,
                         max_local_lm=1024, ba_window=6, ba_fixed=2,
                         new_lm_budget=256, max_frames_between_kf=6)
LCFG = dict(n_neighbors=3, new_lm_budget=256, n_levels=4, scale=1.2, width=W,
            height=H)


def jnp_state(s):
    return {f: np.array(getattr(s, f)) for f in jms.MapState._fields}


def port_state(fields):
    return convert.map_state_from_numpy(fields, "cpu")


def assert_state_close(tstate, ref: dict, atol=1e-4, rtol=1e-5, skip_rows=None):
    """skip_rows: {field: rows} left out of the comparison — rows where the
    reference's scatter writes a pad index's stale value over a real write
    to the same row (index 0), with an unspecified winner."""
    got = convert.map_state_to_numpy(tstate)
    for f in jms.MapState._fields:
        a, b = got[f], ref[f]
        if skip_rows and f in skip_rows:
            a = np.delete(a, skip_rows[f], axis=0)
            b = np.delete(b, skip_rows[f], axis=0)
        if b.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, atol=atol, rtol=rtol, err_msg=f)


def pose(seq, i):
    R_cw = seq.R_wc[i].T.astype(np.float32)
    return R_cw, (-R_cw @ seq.t_wc[i]).astype(np.float32)


@pytest.fixture(scope="module")
def world():
    """JAX frames 0 and 8 (0.32 m apart, past the 0.2 m stereo baseline that
    gates triangulation), KF0 (spawn all), KF1 bound by descriptor match."""
    rng = np.random.default_rng(7)
    wld = jsyn.make_world(rng, n_points=600, extent=7.0, depth_range=(2.5, 9.0))
    seq = jsyn.make_stereo_sequence(rng, n_frames=9, h=H, w=W, fx=FX, baseline=B,
                                    world=wld)
    frames = []
    for i in (0, 8):
        im = np.clip(np.rint([seq.imgs_l[i], seq.imgs_r[i]]), 0, 255).astype(np.uint8)
        frames.append(jframe.build_stereo_frame(
            jnp.asarray(im[0]), jnp.asarray(im[1]), jnp.float32(seq.ts[i]), JCAM,
            jnp.float32(BF), JCFG.orb))
    empty = jms.empty(JCFG.map)
    s0, n0 = jtr.create_keyframe_impl(
        empty, jnp.int32(0), jnp.int32(0), frames[0], jnp.eye(3), jnp.zeros(3),
        jnp.full(400, -1, jnp.int32), jnp.int32(-1), JCAM, jnp.float32(BF), JCFG,
        spawn_all=True)
    has = s0.kf_obs[0] >= 0
    m = jmatch.match_descriptors(s0.kf_desc[0], has, frames[1].desc, frames[1].valid,
                                 ratio=0.8, max_dist=jmatch.TH_LOW, mutual=True)
    cur = jnp.full(401, -1, jnp.int32).at[jnp.where(m.idx >= 0, m.idx, 400)].set(
        jnp.where(m.idx >= 0, s0.kf_obs[0], -1))[:400]
    R1, t1 = pose(seq, 8)
    return dict(seq=seq, frames=frames, empty=jnp_state(empty), s0=jnp_state(s0),
                n0=int(n0), cur1=np.array(cur), R1=R1, t1=t1)


def test_create_keyframe(world):
    f0 = world["frames"][0]
    tstate, n = ttr.create_keyframe_impl(
        port_state(world["empty"]), 0, 0, convert.frame_from_numpy(
            {k: np.array(v) for k, v in f0._asdict().items()}, "cpu"),
        torch.eye(3), torch.zeros(3), torch.full((400,), -1, dtype=torch.int32), -1,
        TCAM, BF, TCFG, spawn_all=True)
    assert int(n) == world["n0"] > 100
    assert_state_close(tstate, world["s0"])


def _kf1(world):
    """JAX state after inserting frame 8 as KF1 with its matched bindings."""
    f1 = world["frames"][1]
    s = jms.MapState(**{k: jnp.asarray(v) for k, v in world["s0"].items()})
    s1, n1 = jtr.create_keyframe_impl(
        s, jnp.int32(1), jnp.int32(world["n0"]), f1, jnp.asarray(world["R1"]),
        jnp.asarray(world["t1"]), jnp.asarray(world["cur1"]), jnp.int32(0), JCAM,
        jnp.float32(BF), JCFG)
    return s1, world["n0"] + int(n1)


def test_insert_triangulate_fuse(world):
    f1 = world["frames"][1]
    s1, n_after = _kf1(world)
    tf1 = convert.frame_from_numpy({k: np.array(v) for k, v in f1._asdict().items()},
                                   "cpu")
    t1, tn = ttr.create_keyframe_impl(
        port_state(world["s0"]), 1, world["n0"], tf1, torch.from_numpy(world["R1"]),
        torch.from_numpy(world["t1"]), torch.from_numpy(world["cur1"]), 0, TCAM, BF, TCFG)
    assert world["n0"] + int(tn) == n_after
    assert_state_close(t1, jnp_state(s1))

    jl, tl = jlm.LocalMapConfig(**LCFG), tlm.LocalMapConfig(**LCFG)
    nb = [0, -1, -1]
    s2, jn = jlm.create_new_landmarks_impl(s1, jnp.int32(1), jnp.asarray(nb),
                                           jnp.int32(n_after), JCAM, jnp.float32(BF), jl)
    t2, tn2 = tlm.create_new_landmarks_impl(port_state(jnp_state(s1)), 1, nb, n_after,
                                            TCAM, BF, tl)
    assert int(tn2) == int(jn) > 0
    # triangulated points: the float32 DLT solves normal equations that square
    # the conditioning (see the reference's triangulate_dlt), so a different
    # summation order moves far points by ~1e-4 of their range
    assert_state_close(t2, jnp_state(s2), rtol=1e-3)

    s3 = jlm.fuse_duplicates_impl(s2, jnp.int32(1), jnp.asarray(nb), JCAM, jl)
    t3 = tlm.fuse_duplicates_impl(port_state(jnp_state(s2)), 1, nb, TCAM, tl)
    assert_state_close(t3, jnp_state(s3))


@pytest.fixture(scope="module")
def mapped(world):
    """numpy fields of the JAX map after KF1's triangulation and fusion (the
    JAX mapping functions donate their input state, so each test rebuilds
    a JAX state from these)."""
    s1, n_after = _kf1(world)
    jl = jlm.LocalMapConfig(**LCFG)
    s2, _ = jlm.create_new_landmarks_impl(s1, jnp.int32(1), jnp.asarray([0, -1, -1]),
                                          jnp.int32(n_after), JCAM, jnp.float32(BF), jl)
    return jnp_state(jlm.fuse_duplicates_impl(s2, jnp.int32(1), jnp.asarray([0, -1, -1]),
                                              JCAM, jl))


def jax_state(ref):
    return jms.MapState(**{k: jnp.asarray(v) for k, v in ref.items()})


def test_map_queries(mapped):
    ref = mapped
    js = jax_state(ref)
    ts = port_state(ref)
    np.testing.assert_array_equal(tms.covisibility(ts).numpy(),
                                  np.asarray(jms.covisibility(js)))
    np.testing.assert_array_equal(tms.landmark_obs_count(ts).numpy(),
                                  np.asarray(jms.landmark_obs_count(js)))
    assert_state_close(tms.update_landmark_stats(ts, 4, 1.2),
                       jnp_state(jms.update_landmark_stats(js, 4, 1.2)))
    win = np.array([1, 0, -1, -1], np.int32)
    inv_s2 = (1.0 / 1.44 ** np.arange(4)).astype(np.float32)
    for a, b in zip(tms.ba_factors_from_map(ts, torch.from_numpy(win), torch.from_numpy(inv_s2)),
                    jms.ba_factors_from_map(js, jnp.asarray(win), jnp.asarray(inv_s2))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    tl, jl = tlm.LocalMapConfig(**LCFG), jlm.LocalMapConfig(**LCFG)
    np.testing.assert_array_equal(
        tlm.redundant_keyframes(ts, [0, -1], tl).numpy(),
        np.asarray(jlm.redundant_keyframes(js, jnp.asarray([0, -1]), jl)))
    assert_state_close(tlm.cull_landmarks(port_state(ref), 2, tl, recent_slots=[1, -1]),
                       jnp_state(jlm.cull_landmarks(js, jnp.int32(2), jl,
                                                    recent_slots=jnp.asarray([1, -1]))))


def test_excise_and_grow(mapped):
    ref = mapped
    # slot 1: culling slot 0 races with the pads' writes in the reference
    # (the tracker never culls its first keyframe)
    cull = np.array([1, -1, -1, -1], np.int32)
    assert_state_close(tms.excise_keyframes(port_state(ref), torch.from_numpy(cull)),
                       jnp_state(jms.excise_keyframes(jax_state(ref), jnp.asarray(cull))))
    old = jms.MapConfig(**MAPC)
    new = old._replace(max_keyframes=16, max_landmarks=4096)
    tnew = tms.MapConfig(**MAPC)._replace(max_keyframes=16, max_landmarks=4096)
    assert_state_close(tms.grow_map(port_state(ref), tms.MapConfig(**MAPC), tnew),
                       jnp_state(jms.grow_map(jax_state(ref), old, new)))


def test_local_ba_stage(mapped):
    ref = mapped
    js, jn = jtr.kf_ba_stage(jax_state(ref), jnp.int32(1), jnp.int32(0), JCAM,
                             jnp.float32(BF), JCFG)
    ts, tn = ttr.kf_ba_stage(port_state(ref), 1, 0, TCAM, BF, TCFG)
    assert int(tn) == int(jn)
    # keyframe 0 is the window's gauge anchor: the reference writes its
    # outlier-pruned observation row and the window's -1 pads (clamped to 0)
    # to the same row; landmark 0 likewise collides with sub_idx pads
    assert_state_close(ts, jnp_state(js), atol=1e-3,
                       skip_rows={"kf_obs": [0], "lm_pos": [0]})
