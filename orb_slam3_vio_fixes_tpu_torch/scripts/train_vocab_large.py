"""Train the production-scale BoW vocabulary: 10^5 leaves, b = 10, d = 5
(the port's twin of scripts/train_vocab_large.py).

The corpus is harvested from a diverse set of synthetic scenes until it
holds `target` descriptors, seed after seed, the scene's kind cycling with
the seed: loop walls (kind 0), sprite worlds (1), renders along EuRoC
ground-truth trajectories (2; only with `gt_dir`, the reference's
evaluation/Ground_truth/EuRoC_left_cam folder, else kind 3), and wide
sprite worlds with a faster camera (3). Odd seeds' left images go through
`io/synthetic.degrade_images` with `DEFAULT_NOISE` (blur, vignette and
exposure drift, occluders, shot and read noise), so that word assignment
holds up under the imaging conditions the tests use. Every frame goes
through the stereo frame build at `ORBConfig(1024, 8)` (the FAST kernel on
the pair's atlas, the Hamming kernel in the stereo match). The draws are
the reference script's, in its order.

    python -m orb_slam3_vio_fixes_tpu_torch.scripts.train_vocab_large \
        [--out PATH] [--gt-dir DIR] [--cpu]

It writes `build/vocab/vocab_b10d5.npz` under the repository by default,
never the JAX package's checked-in assets.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from orb_slam3_vio_fixes_tpu_torch.io import synthetic
from orb_slam3_vio_fixes_tpu_torch.ops import orb
from orb_slam3_vio_fixes_tpu_torch.scripts import device_for
from orb_slam3_vio_fixes_tpu_torch.scripts.train_default_vocab import ROOT, frame_descriptors
from orb_slam3_vio_fixes_tpu_torch.slam_map import vocabulary as voc

DEFAULT_OUT = os.path.join(ROOT, "build", "vocab", "vocab_b10d5.npz")
ORB_CONFIG = orb.ORBConfig(n_features=1024, n_levels=8)
GT_FILES = ("MH01_GT.txt", "V101_GT.txt", "V201_GT.txt", "MH03_GT.txt")


def seed_frames(seed: int, gt_dir=None):
    """The (left, right) float32 image pairs of one seed, in the order the
    frame build gets them (kind 2 only where `gt_dir` is a directory)."""
    rng = np.random.default_rng(seed)
    kind = seed % 4
    if kind == 0:
        seq = synthetic.make_loop_stereo_sequence(
            rng, n_frames=32, h=240, w=352, fx=260.0, baseline=0.2,
            radius=1.5 + 0.4 * seed, wall_radius=7.0 + (seed % 5),
            n_points=1200 + 120 * (seed % 7))
    elif kind == 1:
        world = synthetic.make_world(rng, n_points=600 + 90 * (seed % 9),
                                     extent=6.0 + (seed % 5),
                                     depth_range=(2.5, 9.0 + seed % 6))
        seq = synthetic.make_stereo_sequence(rng, n_frames=32, h=240, w=352, fx=260.0,
                                             baseline=0.2, world=world,
                                             yaw_rate=0.04 * (seed % 3))
    elif kind == 2 and gt_dir is not None and os.path.isdir(gt_dir):
        gt = GT_FILES[(seed // 4) % len(GT_FILES)]
        seq = synthetic.make_gt_stereo_sequence(
            rng, os.path.join(gt_dir, gt), n_frames=32, stride=6, h=240, w=352,
            fx=260.0, baseline=0.2, n_points=900 + 80 * (seed % 6))
    else:
        world = synthetic.make_world(rng, n_points=900, extent=10.0, depth_range=(4.0, 16.0))
        seq = synthetic.make_stereo_sequence(rng, n_frames=32, h=240, w=352, fx=260.0,
                                             baseline=0.2, world=world,
                                             speed=(0.4, 0.1, 0.3), yaw_rate=0.1)
    imgs_l = seq.imgs_l
    if seed % 2 == 1:
        imgs_l = synthetic.degrade_images(imgs_l, rng, synthetic.DEFAULT_NOISE)
    for i in range(imgs_l.shape[0]):
        yield (np.asarray(imgs_l[i], np.float32), np.asarray(seq.imgs_r[i], np.float32))


def harvest(target: int = 600_000, device="cuda", gt_dir=None) -> np.ndarray:
    """The (N, 8) uint32 descriptor corpus: whole seeds until it holds at
    least `target` descriptors."""
    pool = []
    n_total = 0
    seed = 0
    while n_total < target:
        for img_l, img_r in seed_frames(seed, gt_dir):
            d = frame_descriptors(img_l, img_r, device, ORB_CONFIG)
            pool.append(d)
            n_total += len(d)
        print(f"seed {seed}: corpus {n_total}", flush=True)
        seed += 1
    return np.concatenate(pool)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--gt-dir", default=None,
                    help="EuRoC ground-truth files (MH01_GT.txt, ...) for the kind-2 scenes")
    ap.add_argument("--cpu", action="store_true", help="run on the host, not the card")
    args = ap.parse_args(argv)
    device = device_for(args.cpu)
    corpus = harvest(device=device, gt_dir=args.gt_dir)
    print(f"training on {len(corpus)} descriptors (b=10, d=5: 10^5 words)", flush=True)
    vocab = voc.train(corpus, branching=10, depth=5, seed=0, device=device)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    voc.save(vocab, args.out)
    n_used = int((vocab.weights > 1e-3).sum())
    print(f"saved {args.out} ({os.path.getsize(args.out)} bytes, "
          f"{vocab.weights.shape[0]} words, {n_used} with idf weight)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
