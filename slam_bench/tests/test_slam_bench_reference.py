"""The references that decide `correct`, on hand-made cases: Horn's ATE
and the relative pose errors, the FAST score, the Hamming best-2, and the
frame reference against the SLAM package's frame build on a small
rendered pair."""

import math

import numpy as np
import pytest
import torch

from slam_bench import render
from slam_bench.reference import frame as ref_frame
from slam_bench.reference import hamming, trajectory
from slam_bench.scene import so3_exp


def circle(n=30):
    a = np.linspace(0, 2, n)
    t_wc = np.stack([3 * np.sin(a), 0.1 * a, -3 * np.cos(a)], 1)
    R_wc = np.stack([so3_exp([0.0, math.pi - x, 0.0]) for x in a])
    return R_wc, t_wc


def to_cw(R_wc, t_wc):
    R_cw = np.transpose(R_wc, (0, 2, 1))
    return R_cw, -(R_cw @ t_wc[..., None])[..., 0]


def test_horn_ate_is_blind_to_the_world_frame_and_sees_an_offset():
    _, c = circle()
    Rg = so3_exp([0.3, -0.2, 1.1])
    moved = c @ Rg.T + np.array([5.0, -2.0, 0.5])
    assert trajectory.horn_ate(moved, c) < 1e-9
    off = c.copy()
    off[::2, 0] += 0.02
    off[1::2, 0] -= 0.02
    assert trajectory.horn_ate(off, c) == pytest.approx(0.02, rel=1e-2)


def test_relative_errors():
    R_wc, t_wc = circle()
    R_cw, t_cw = to_cw(R_wc, t_wc)
    deg, m = trajectory.relative_errors(R_cw, t_cw, R_wc, t_wc)
    assert deg.max() < 1e-6 and m.max() < 1e-12
    # the estimate in another world frame X' = G X + d: the same motions
    G, d = so3_exp([0.1, 0.5, -0.3]), np.array([1.0, 2.0, 3.0])
    R2 = R_cw @ G.T
    deg, m = trajectory.relative_errors(R2, t_cw - (R2 @ d[:, None])[..., 0], R_wc, t_wc)
    assert deg.max() < 1e-6 and m.max() < 1e-12
    # one frame stale: the step into it and out of it read the whole motion
    R_s, t_s = R_cw.copy(), t_cw.copy()
    R_s[10], t_s[10] = R_cw[9], t_cw[9]
    deg, m = trajectory.relative_errors(R_s, t_s, R_wc, t_wc)
    step = np.linalg.norm(t_wc[10] - t_wc[9])
    assert m[9] == pytest.approx(step, rel=0.05) and m[10] == pytest.approx(step, rel=0.05)
    assert deg[9] == pytest.approx(math.degrees(2 / 29), rel=1e-6)
    assert np.delete(m, [9, 10]).max() < 1e-12
    assert trajectory.rms([3.0, 4.0]) == pytest.approx(math.sqrt(12.5))


def ring_image(values, centre=100.0):
    img = torch.full((1, 9, 9), centre)
    for (dy, dx), v in zip(ref_frame.CIRCLE, values):
        img[0, 4 + dy, 4 + dx] = v
    return img


@pytest.mark.parametrize("n_bright,expect", [(9, 50.0), (12, 50.0), (8, 0.0)])
def test_fast_score_bright_arcs(n_bright, expect):
    vals = [150.0] * n_bright + [100.0] * (16 - n_bright)
    vals = vals[5:] + vals[:5]          # the arc wraps round the ring
    assert float(ref_frame.fast_score(ring_image(vals))[0, 4, 4]) == expect


def test_fast_score_dark_arc_and_border():
    vals = [100.0] * 7 + [70.0, 40.0, 40.0, 40.0, 40.0, 40.0, 40.0, 40.0, 40.0]
    s = ref_frame.fast_score(ring_image(vals))
    assert float(s[0, 4, 4]) == 30.0            # min over the 9 darkest is 70
    assert float(s[0, :3].abs().sum() + s[0, :, :3].abs().sum()) == 0.0


def words(bits):
    """(n, 256) 0/1 -> (n, 8) int32 words, bit s of word k is bit 32k + s."""
    b = np.asarray(bits, np.int64).reshape(-1, 8, 32)
    w = (b << np.arange(32)).sum(-1)
    return torch.as_tensor(np.where(w >= 2**31, w - 2**32, w).astype(np.int32))


def test_hamming_best2_hand_made():
    q = np.zeros((2, 256), int)
    t = np.zeros((4, 256), int)
    t[0, :10] = 1          # distance 10 from query 0
    t[1, :3] = 1           # 3
    t[2, 200:203] = 1      # 3, a tie with t1: the first index wins
    t[3, :] = 1            # 256
    q[1, :] = 1            # query 1: distances 246, 253, 253, 0
    mask = torch.tensor([[True, True, True, True], [True, True, True, False]])
    bi, b, s, si, ci = hamming.best2(words(q), words(t), mask, True)
    assert bi.tolist() == [1, 0] and b.tolist() == [3, 246]
    assert s.tolist() == [3, 253] and si.tolist() == [2, 1]
    assert ci.tolist() == [0, 0, 0, 0]
    assert hamming.distances(words(q), words(t))[1, 3] == 0
    none = torch.zeros((2, 4), dtype=torch.bool)
    _, b, s, _, _ = hamming.best2(words(q), words(t), none, False)
    assert b.tolist() == [hamming.BIG] * 2 and s.tolist() == [hamming.BIG] * 2


def test_frame_reference_equals_the_slam_packages_frame_build():
    from orb_slam3_vio_fixes_tpu_torch.ops import fast, image, orb

    cam = render.Camera(160.0, 160.0, 128.0, 80.0, 256, 160)
    g = torch.Generator().manual_seed(2)
    m = 400
    w = render.World(torch.stack([torch.empty(m).uniform_(-5, 5, generator=g),
                                  torch.empty(m).uniform_(-3, 3, generator=g),
                                  torch.empty(m).uniform_(3, 9, generator=g)], 1),
                     torch.empty(m).uniform_(0.06, 0.16, generator=g),
                     torch.empty(m, 12, 12).uniform_(70, 250, generator=g))
    imgs = render.render_many(w, cam, np.stack([np.eye(3)] * 2),
                              np.array([[0.0, 0, 0], [-0.11, 0, 0]])).round()
    orb_cfg = {"nFeatures": 300, "nLevels": 4, "scaleFactor": 1.2, "iniThFAST": 20,
               "minThFAST": 7}
    lay = image.atlas_layout(160, 256, 4, 1.2, align=35)
    atlas = image.build_pyramid_atlas(imgs, 4, 1.2, lay)
    assert torch.equal(ref_frame.atlas(imgs, 4, 1.2, 35), atlas)
    scores = fast.fast_score_batch(atlas)
    assert torch.equal(ref_frame.fast_score(atlas), scores)
    f = orb.extract_batch(imgs, orb.ORBConfig(n_features=300, n_levels=4))
    ay, ax, valid, octave = ref_frame.select(scores, (160, 256), orb_cfg)
    assert valid.sum() > 200
    assert torch.equal(valid, f.valid) and torch.equal(octave, f.octave)
    assert torch.equal(ref_frame.keypoint_uv(ay, ax, octave, (160, 256), orb_cfg), f.uv)
    p = ref_frame.patches(ref_frame.blur(atlas).to(torch.bfloat16), ay, ax)
    assert (ref_frame.orientation(p) - f.angle).abs().max() < 1e-5
    assert torch.equal(ref_frame.describe(p, f.angle), ref_frame.unpack_bits(f.desc))
