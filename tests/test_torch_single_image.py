"""The port's single-image entries and the vocabulary's file layout, against
the JAX package on the same numpy inputs.

Tolerances and why:
  * `fast.fast_score` against `_fast_score_xla`: exact (integer
    arithmetic; on the CPU the wrapper runs K1's plain twin);
  * `fast.detect` against JAX `detect`: exact indices, scores and valid
    flags (the same two-tier threshold, NMS, iterated cell-max selection and
    a top-k whose ties go in index order, as lax.top_k's);
  * `orb.extract` against JAX `extract`: test_torch_frame's bars for
    `extract_batch` (keypoint IoU >= 0.98, descriptor bits >= 99.5% on the
    common keypoints: the pyramid's resize sums weights in another order);
  * `vocabulary.save` / `load`: each package's `load` reads the other's
    file to the same arrays, bit for bit.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_vio_fixes_tpu.ops import fast as jfast
from orb_slam3_vio_fixes_tpu.ops import orb as jorb
from orb_slam3_vio_fixes_tpu.slam_map import vocabulary as jvoc
from orb_slam3_vio_fixes_tpu_torch.frontend import frame as tframe
from orb_slam3_vio_fixes_tpu_torch.io import synthetic as tsyn
from orb_slam3_vio_fixes_tpu_torch.ops import fast as tfast
from orb_slam3_vio_fixes_tpu_torch.ops import orb as torb
from orb_slam3_vio_fixes_tpu_torch.slam_map import vocabulary as tvoc

from test_torch_frame import _keys

torch.set_num_threads(2)

H, W = 240, 352


@pytest.fixture(scope="module")
def frame():
    """A rendered frame quantised as a camera gives it, (H, W) float32."""
    rng = np.random.default_rng(3)
    world = tsyn.make_world(rng, n_points=500, extent=7.0, depth_range=(2.5, 9.0))
    K = np.array([[260.0, 0, W / 2], [0, 260.0, H / 2], [0, 0, 1]], np.float32)
    img = tsyn.render(world, K, np.eye(3, dtype=np.float32), np.zeros(3, np.float32), H, W)
    return np.clip(np.rint(img), 0, 255).astype(np.float32)


def _images(frame):
    rng = np.random.default_rng(8)
    return {"rendered": frame,
            "random": rng.integers(0, 256, (61, 83)).astype(np.float32),
            "half": 0.5 * rng.integers(0, 511, (40, 53)).astype(np.float32)}


@pytest.mark.parametrize("kind", ["rendered", "random", "half"])
def test_fast_score_single_image(frame, kind):
    img = _images(frame)[kind]
    ref = np.asarray(jfast._fast_score_xla(jnp.asarray(img)))
    got = tfast.fast_score(torch.from_numpy(img))
    assert got.shape == img.shape and got.dtype == torch.float32
    assert (ref > 0).any()
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("kind,kw", [
    ("rendered", {}),
    ("rendered", dict(threshold=12.0, threshold_min=5.0, cell=20, max_per_cell=2,
                      budget=400)),
    ("random", dict(budget=128)),
    ("half", dict(cell=16, budget=64)),
])
def test_detect(frame, kind, kw):
    img = _images(frame)[kind]
    j_idx, j_score, j_valid = (np.asarray(a) for a in jfast.detect(jnp.asarray(img), **kw))
    t_idx, t_score, t_valid = tfast.detect(torch.from_numpy(img), **kw)
    assert t_idx.dtype == torch.int32 and j_valid.sum() > 10
    np.testing.assert_array_equal(t_score.numpy(), j_score)
    np.testing.assert_array_equal(t_valid.numpy(), j_valid)
    np.testing.assert_array_equal(t_idx.numpy(), j_idx)


def test_extract_single_image(frame):
    cfg_j = jorb.ORBConfig(n_features=400, n_levels=4)
    cfg_t = torb.ORBConfig(n_features=400, n_levels=4)
    jf = jorb.extract(jnp.asarray(frame), cfg_j)
    tf = torb.extract(torch.from_numpy(frame), cfg_t)
    assert tf.uv.shape == (400, 2) and tf.desc.shape == (400, 8)
    jk = _keys(np.asarray(jf.uv), np.asarray(jf.octave), np.asarray(jf.valid))
    tk = _keys(tf.uv.numpy(), tf.octave.numpy(), tf.valid.numpy())
    common = jk.keys() & tk.keys()
    iou = len(common) / len(jk.keys() | tk.keys())
    assert len(jk) > 200 and iou >= 0.98, (len(jk), iou)
    ji = np.array([jk[k] for k in common])
    ti = np.array([tk[k] for k in common])
    jd = np.asarray(jf.desc).view(np.uint8)
    td = tf.desc.numpy().view(np.uint8)
    assert 1.0 - np.unpackbits(jd[ji] ^ td[ti], axis=1).mean() >= 0.995
    # the one-image frame path (mono, RGB-D) is this entry
    one = tframe._extract_one(torch.from_numpy(frame.astype(np.uint8)), cfg_t)
    for a, b in zip(one, tf):
        assert torch.equal(a, b)


def test_vocabulary_save_load_both_ways(tmp_path):
    descs = np.random.default_rng(2).integers(0, 2**32, (400, 8), dtype=np.uint32)
    tv = tvoc.train(descs.view(np.int32), branching=4, depth=3, seed=1, device="cpu")
    jv = jvoc.train(descs, branching=4, depth=3, seed=1)
    # the port's file read by the reference
    p_port = str(tmp_path / "port.npz")
    tvoc.save(tv, p_port)
    back_j = jvoc.load(p_port)
    nodes, weights = tvoc.to_numpy(tv)
    np.testing.assert_array_equal(np.asarray(back_j.nodes), nodes)
    np.testing.assert_array_equal(np.asarray(back_j.weights), weights)
    assert (back_j.branching, back_j.depth) == (4, 3)
    np.testing.assert_array_equal(np.asarray(back_j.nodes), np.asarray(jv.nodes))
    # the reference's file read by the port, and the port's by itself
    p_ref = str(tmp_path / "ref.npz")
    jvoc.save(jv, p_ref)
    for path in (p_ref, p_port):
        back_t = tvoc.load(path, "cpu")
        assert (back_t.branching, back_t.depth) == (4, 3)
        assert torch.equal(back_t.nodes, tv.nodes)
        np.testing.assert_array_equal(back_t.weights.numpy(), np.asarray(jv.weights))
    with np.load(p_port) as z, np.load(p_ref) as r:
        assert sorted(z.files) == sorted(r.files)
        for k in z.files:
            assert z[k].dtype == r[k].dtype, k
