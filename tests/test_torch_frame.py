"""Parity of the port's frame build (pyramid atlas, FAST score, keypoint
selection, orientation + steered BRIEF, stereo row match + SAD sub-pixel)
with the JAX package on the test_e2e_stereo scene, plus the fixed tables.

Tolerances and why:
  * fixed tables (BRIEF pattern, moment weights, binned BRIEF offsets):
    identical — same numpy code;
  * pyramid atlas: max abs diff <= 1e-2 gray — F.interpolate's antialiased
    bilinear and jax.image.resize sum the same triangle weights in another
    order (measured ~2e-3);
  * FAST score on the SAME atlas: exact — integer arithmetic;
  * keypoint set IoU >= 0.98 — the pyramid's ~1e-3 differences flip the
    integer rounding of a few pixels sitting on .5, moving a few scores;
  * descriptor bits >= 99.5% on common keypoints — the orientation's bf16
    moment sums run in another order, which can move an angle across one of
    the 64 rotation bins;
  * stereo ur within 1e-3 px (depth within 1e-3 relative) on >= 98% of the
    keypoints both sides stereo-match — float32 SAD sums in another order.
"""

import gc
import jax
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_vio_fixes_tpu.frontend import frame as jframe
from orb_slam3_vio_fixes_tpu.io import synthetic as jsyn
from orb_slam3_vio_fixes_tpu.ops import fast as jfast
from orb_slam3_vio_fixes_tpu.ops import image as jimage
from orb_slam3_vio_fixes_tpu.ops import orb as jorb
from orb_slam3_vio_fixes_tpu.utils.cameras import Camera as JCamera
from orb_slam3_vio_fixes_tpu_torch.frontend import frame as tframe
from orb_slam3_vio_fixes_tpu_torch.io import synthetic as tsyn
from orb_slam3_vio_fixes_tpu_torch.ops import fast as tfast
from orb_slam3_vio_fixes_tpu_torch.ops import image as timage
from orb_slam3_vio_fixes_tpu_torch.ops import orb as torb
from orb_slam3_vio_fixes_tpu_torch.utils.cameras import Camera as TCamera

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def _release_jax_executables():
    """Free the JAX executables this module compiled once it ends: each holds
    hundreds of memory mappings, and an xdist worker that runs several
    compile-heavy files can reach the per-process mapping limit."""
    yield
    jax.clear_caches()
    gc.collect()


H, W = 240, 352
JCFG = jorb.ORBConfig(n_features=400, n_levels=4)
TCFG = torb.ORBConfig(n_features=400, n_levels=4)


def _scene(mod, n_frames):
    rng = np.random.default_rng(7)
    world = mod.make_world(rng, n_points=600, extent=7.0, depth_range=(2.5, 9.0))
    return mod.make_stereo_sequence(rng, n_frames=n_frames, h=H, w=W, fx=260.0,
                                    baseline=0.2, world=world)


@pytest.fixture(scope="module")
def seq():
    return _scene(jsyn, 2)


@pytest.fixture(scope="module")
def imgs(seq):
    """Frame 0 as the trackers see it: uint8-quantised (2, H, W)."""
    a = np.stack([seq.imgs_l[0], seq.imgs_r[0]])
    return np.clip(np.rint(a), 0, 255).astype(np.uint8)


def test_port_generator_matches_reference(seq):
    """The port's numpy scene generator renders the reference's images (its
    so3_exp is numpy float32 instead of JAX: sub-ulp pose differences move
    a few sprite-edge pixels by a fraction of a gray level)."""
    tseq = _scene(tsyn, 2)
    np.testing.assert_allclose(tseq.R_wc, seq.R_wc, atol=1e-7)
    np.testing.assert_array_equal(tseq.t_wc, seq.t_wc)
    diff = np.abs(tseq.imgs_l - seq.imgs_l)
    assert diff.max() < 0.5 and (diff > 1e-3).mean() < 1e-3
    # and its stereo-inertial sequence: the same IMU samples and states
    vi = [mod.make_stereo_inertial_sequence(
        np.random.default_rng(5), n_frames=3, h=H, w=W, fx=260.0, baseline=0.2,
        world=mod.make_world(np.random.default_rng(5), n_points=100), imu_hz=200.0)
        for mod in (jsyn, tsyn)]
    for f in ("imu", "vel_gt", "t_wc", "ts"):
        np.testing.assert_allclose(getattr(vi[1], f), getattr(vi[0], f), atol=1e-6,
                                   err_msg=f)
    np.testing.assert_allclose(vi[1].R_wc, vi[0].R_wc, atol=1e-7)
    assert np.abs(vi[1].imgs_r - vi[0].imgs_r).max() < 0.5


def test_fixed_tables_identical():
    np.testing.assert_array_equal(torb.brief_pattern(), jorb.brief_pattern())
    np.testing.assert_array_equal(torb._moment_matrix(), jorb._moment_matrix())
    offs = torb.brief_bin_offsets()                 # (64, 256, 2)
    P = torb.PATCH * torb.PATCH
    Wd = np.zeros((64, P, 256), np.float32)
    b, s = np.meshgrid(np.arange(64), np.arange(256), indexing="ij")
    np.add.at(Wd, (b, offs[..., 0], s), 1.0)
    np.add.at(Wd, (b, offs[..., 1], s), -1.0)
    np.testing.assert_array_equal(Wd.transpose(1, 0, 2).reshape(P, 64 * 256),
                                  jorb._brief_diff_matrix())


def _atlases(imgs):
    layout = jimage.atlas_layout(H, W, 4, 1.2, align=35)
    assert layout == timage.atlas_layout(H, W, 4, 1.2, align=35)
    ja = np.stack([np.asarray(jimage.build_pyramid_atlas(
        jnp.asarray(im, jnp.float32), 4, 1.2, layout)) for im in imgs])
    ta = timage.build_pyramid_atlas(torch.from_numpy(imgs), 4, 1.2, layout).numpy()
    return ja, ta


def test_pyramid_and_fast_score(imgs):
    ja, ta = _atlases(imgs)
    assert np.abs(ja - ta).max() <= 1e-2
    ref = np.stack([np.asarray(jfast._fast_score_xla(jnp.asarray(a))) for a in ja])
    got = tfast.fast_score_batch(torch.from_numpy(ja)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("h,w,half", [(40, 53, False), (40, 53, True),
                                      (7, 37, False), (7, 37, True),
                                      (24, 751, True)])
def test_fast_score_plain_matches_xla(rng, h, w, half):
    """The plain twin's 3-ary chain (the kernel's, index for index, with the
    centre out of the chain) against the reference's 9-step minimum, on
    integer and half-integer
    intensities (the round-half-to-even step) and odd shapes."""
    x = rng.integers(0, 511 if half else 256, (2, h, w)).astype(np.float32)
    if half:
        x *= 0.5
    ref = np.stack([np.asarray(jfast._fast_score_xla(jnp.asarray(a))) for a in x])
    got = tfast.fast_score_batch(torch.from_numpy(x)).numpy()
    assert (ref > 0).any()
    np.testing.assert_array_equal(got, ref)


def _keys(uv, octave, valid):
    return {(int(o), round(float(u), 2), round(float(v), 2)): i
            for i, ((u, v), o, ok) in enumerate(zip(uv, octave, valid)) if ok}


def test_extraction_keypoints_and_descriptors(imgs):
    jf = jorb._extract_batch(jnp.asarray(imgs, jnp.float32), JCFG, H, W)
    tf = torb.extract_batch(torch.from_numpy(imgs).to(torch.float32), TCFG)
    for eye in range(2):
        jk = _keys(np.asarray(jf.uv[eye]), np.asarray(jf.octave[eye]),
                   np.asarray(jf.valid[eye]))
        tk = _keys(tf.uv[eye].numpy(), tf.octave[eye].numpy(), tf.valid[eye].numpy())
        common = jk.keys() & tk.keys()
        iou = len(common) / len(jk.keys() | tk.keys())
        assert len(jk) > 300 and iou >= 0.98, (eye, len(jk), iou)
        jd = np.asarray(jf.desc[eye]).view(np.uint8)
        td = tf.desc[eye].numpy().view(np.uint8)
        ji = np.array([jk[k] for k in common])
        ti = np.array([tk[k] for k in common])
        agree = 1.0 - np.unpackbits(jd[ji] ^ td[ti], axis=1).mean()
        assert agree >= 0.995, (eye, agree)


def test_stereo_frame(imgs):
    fx, cx, cy = 260.0, W / 2, H / 2
    bf = fx * 0.2
    jfr = jframe.build_stereo_frame(
        jnp.asarray(imgs[0]), jnp.asarray(imgs[1]), jnp.float32(0.0),
        JCamera.pinhole(fx, fx, cx, cy), jnp.float32(bf), JCFG)
    tfr = tframe.build_stereo_frame_impl(
        torch.from_numpy(imgs[0]), torch.from_numpy(imgs[1]),
        torch.tensor(0.0), TCamera.pinhole(fx, fx, cx, cy), bf, TCFG)
    jk = _keys(np.asarray(jfr.uv), np.asarray(jfr.octave), np.asarray(jfr.valid))
    tk = _keys(tfr.uv.numpy(), tfr.octave.numpy(), tfr.valid.numpy())
    common = sorted(jk.keys() & tk.keys())
    ji = np.array([jk[k] for k in common])
    ti = np.array([tk[k] for k in common])
    jur, tur = np.asarray(jfr.ur)[ji], tfr.ur.numpy()[ti]
    jz, tz = np.asarray(jfr.depth)[ji], tfr.depth.numpy()[ti]
    both = (jur >= 0) & (tur >= 0)
    either = (jur >= 0) | (tur >= 0)
    assert both.sum() > 100 and both.sum() >= 0.98 * either.sum()
    ok = (np.abs(jur - tur) <= 1e-3) & (np.abs(jz - tz) <= 1e-3 * jz)
    assert ok[both].mean() >= 0.98, ok[both].mean()
