"""The port's vocabulary and keyframe database (slam_map/vocabulary.py)
against the JAX package's, on 1024 descriptors of a rendered 752x480 frame
(the port's frame build) and random keyframe histograms.

Tolerances: word assignment and trained trees exact (integer descents and
the same numpy k-medians); histograms, L1 scores and query scores within
1e-6 (float32 sums in another order); query ids exact.
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_vio_fixes_tpu.slam_map import vocabulary as jvoc
from orb_slam3_vio_fixes_tpu_torch.frontend.frame import build_stereo_frame_impl
from orb_slam3_vio_fixes_tpu_torch.io import synthetic
from orb_slam3_vio_fixes_tpu_torch.ops.orb import ORBConfig
from orb_slam3_vio_fixes_tpu_torch.slam_map import vocabulary as tvoc
from orb_slam3_vio_fixes_tpu_torch.utils.cameras import Camera

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def descs():
    """(1024, 8) uint32 descriptors of one rendered 752x480 stereo frame."""
    rng = np.random.default_rng(7)
    world = synthetic.make_world(rng, n_points=1400, extent=10.0, depth_range=(3.0, 14.0))
    seq = synthetic.make_stereo_sequence(rng, n_frames=1, h=480, w=752, fx=458.0,
                                         baseline=0.11, world=world)
    q = lambda a: torch.as_tensor(np.clip(np.rint(a), 0, 255).astype(np.uint8))
    K = seq.K
    f = build_stereo_frame_impl(q(seq.imgs_l[0]), q(seq.imgs_r[0]), torch.zeros(()),
                                Camera.pinhole(K[0, 0], K[1, 1], K[0, 2], K[1, 2]),
                                K[0, 0] * seq.baseline, ORBConfig(1024, 8))
    d = f.desc[f.valid].numpy().view(np.uint32)
    assert len(d) > 900
    return np.resize(d, (1024, 8))


@pytest.fixture(scope="module", params=["artifact_b10d5", "artifact_b10d4",
                                        "trained_b8d2", "trained_b10d3"])
def vocabs(request, descs):
    kind, shape = request.param.split("_")
    if kind == "artifact":
        path = f"{tvoc.ASSET_DIR}/vocab_{shape}.npz"
        return jvoc.load(path), tvoc.load(path, "cpu")
    b, d = (int(x) for x in shape[1:].split("d"))
    return (jvoc.train(descs, branching=b, depth=d, seed=0),
            tvoc.train(descs, branching=b, depth=d, seed=0, device="cpu"))


def test_vocabulary_arrays_agree(vocabs):
    jv, tv = vocabs
    nodes, weights = tvoc.to_numpy(tv)
    assert nodes.dtype == np.uint32 and tv.nodes.dtype == torch.int32
    np.testing.assert_array_equal(nodes, np.asarray(jv.nodes))
    np.testing.assert_array_equal(weights, np.asarray(jv.weights))
    assert (tv.branching, tv.depth, tv.n_words) == (jv.branching, jv.depth, jv.n_words)


def test_assign_words_exact(vocabs, descs):
    jv, tv = vocabs
    valid = np.arange(1024) % 17 != 3
    jw = np.asarray(jvoc.assign_words(jv, jnp.asarray(descs), jnp.asarray(valid)))
    tw = tvoc.assign_words(tv, torch.as_tensor(descs.view(np.int32)),
                           torch.as_tensor(valid)).numpy()
    np.testing.assert_array_equal(tw, jw)
    assert (tw[~valid] == -1).all() and len(np.unique(tw[valid])) > 50


def _histograms(jv, tv, descs, n):
    """n keyframe histograms from random 300-descriptor subsets."""
    rng = np.random.default_rng(3)
    hs = []
    for _ in range(n):
        sub = descs[rng.choice(1024, 300, replace=False)]
        w = jvoc.assign_words(jv, jnp.asarray(sub), jnp.ones(300, bool))
        hs.append(np.asarray(jvoc.bow_histogram(jv, w)))
    return np.stack(hs)


def test_histogram_and_scores(vocabs, descs):
    jv, tv = vocabs
    words = np.array(jvoc.assign_words(jv, jnp.asarray(descs), jnp.ones(1024, bool)))
    words[::5] = -1
    jh = np.asarray(jvoc.bow_histogram(jv, jnp.asarray(words)))
    th = tvoc.bow_histogram(tv, torch.as_tensor(words, dtype=torch.int64)).numpy()
    np.testing.assert_allclose(th, jh, atol=1e-6)
    assert abs(th.sum() - 1.0) < 1e-5
    db = _histograms(jv, tv, descs, 12)
    np.testing.assert_allclose(
        tvoc.l1_score(torch.as_tensor(th), torch.as_tensor(db)).numpy(),
        np.asarray(jvoc.l1_score(jnp.asarray(jh), jnp.asarray(db))), atol=1e-6)


@pytest.mark.parametrize("min_score", [0.0, 0.3])
def test_db_query_and_grouped(vocabs, descs, min_score):
    jv, tv = vocabs
    K = 16
    hist = np.zeros((K, jv.n_words), np.float32)
    hist[:12] = _histograms(jv, tv, descs, 12)
    jdb = jvoc.KeyFrameDatabase(jnp.asarray(hist))
    tdb = tvoc.KeyFrameDatabase.empty(K, tv.n_words, "cpu")
    for k in range(12):
        tvoc.db_add(tdb, k, torch.as_tensor(hist[k]))
    q = hist[4] * 0.7 + hist[9] * 0.3
    exclude = np.zeros(K, bool)
    exclude[9] = True
    rng = np.random.default_rng(5)
    cov = rng.integers(0, 60, (K, K)).astype(np.float32)
    cov = np.triu(cov, 1) + np.triu(cov, 1).T
    ji, js = jvoc.db_query(jdb, jnp.asarray(q), jnp.asarray(exclude),
                           jnp.float32(min_score), n_best=3)
    ti, ts = tvoc.db_query(tdb, torch.as_tensor(q), torch.as_tensor(exclude), min_score,
                           n_best=3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    ji, js = jvoc.db_query_grouped(jdb, jnp.asarray(q), jnp.asarray(cov),
                                   jnp.asarray(exclude), jnp.float32(min_score), n_best=3)
    ti, ts = tvoc.db_query_grouped(tdb, torch.as_tensor(q), torch.as_tensor(cov),
                                   torch.as_tensor(exclude), min_score, n_best=3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)


@pytest.mark.parametrize("shape", [(8, 2), (10, 2), (4, 3), (6, 3), (16, 2), (10, 3)])
def test_train_same_tree(descs, shape):
    b, d = shape
    jv = jvoc.train(descs[:600], branching=b, depth=d, seed=3)
    tv = tvoc.train(descs[:600].view(np.int32), branching=b, depth=d, seed=3, device="cpu")
    nodes, weights = tvoc.to_numpy(tv)
    np.testing.assert_array_equal(nodes, np.asarray(jv.nodes))
    np.testing.assert_array_equal(weights, np.asarray(jv.weights))
