"""Train the framework's default 10^4-word BoW vocabulary (b = 10, d = 4;
the port's twin of scripts/train_default_vocab.py).

The corpus is harvested from six synthetic scenes, loop walls on even seeds
and sprite worlds on odd ones, 24 frames of 240x352 each: every second
frame, its left image with 1.5 gray levels of noise, goes through the
stereo frame build (`frontend/frame.build_stereo_frame_impl`,
`ORBConfig(512, 4)`: the FAST kernel on the pair's atlas, the Hamming
kernel in the stereo match) and its valid descriptors join the corpus. The
draws are the reference script's, in its order.

    python -m orb_slam3_vio_fixes_tpu_torch.scripts.train_default_vocab \
        [--out PATH] [--cpu]

It writes `build/vocab/vocab_b10d4.npz` under the repository by default,
never the JAX package's checked-in assets.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from orb_slam3_vio_fixes_tpu_torch.frontend.frame import build_stereo_frame_impl
from orb_slam3_vio_fixes_tpu_torch.io import synthetic
from orb_slam3_vio_fixes_tpu_torch.ops import orb
from orb_slam3_vio_fixes_tpu_torch.scripts import device_for
from orb_slam3_vio_fixes_tpu_torch.slam_map import vocabulary as voc
from orb_slam3_vio_fixes_tpu_torch.utils.cameras import Camera

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(ROOT, "build", "vocab", "vocab_b10d4.npz")
SEEDS = 6
N_FRAMES = 24           # per seed; every second frame is harvested
ORB_CONFIG = orb.ORBConfig(n_features=512, n_levels=4)
CAM = Camera.pinhole(260.0, 260.0, 176.0, 120.0)
BF = 52.0


def seed_frames(seed: int):
    """The (left, right) float32 image pairs of one seed, in the order the
    frame build gets them."""
    rng = np.random.default_rng(seed)
    if seed % 2 == 0:
        seq = synthetic.make_loop_stereo_sequence(
            rng, n_frames=N_FRAMES, h=240, w=352, fx=260.0, baseline=0.2,
            radius=2.0 + seed * 0.5, wall_radius=8.0 + seed, n_points=1200 + 100 * seed)
    else:
        world = synthetic.make_world(rng, n_points=700 + 100 * seed, extent=8.0,
                                     depth_range=(3.0, 12.0))
        seq = synthetic.make_stereo_sequence(rng, n_frames=N_FRAMES, h=240, w=352, fx=260.0,
                                             baseline=0.2, world=world)
    for i in range(0, seq.imgs_l.shape[0], 2):
        img = seq.imgs_l[i] + rng.normal(0, 1.5, seq.imgs_l[i].shape)
        yield img.astype(np.float32), seq.imgs_r[i].astype(np.float32)


def frame_descriptors(img_l, img_r, device, cfg=ORB_CONFIG) -> np.ndarray:
    """The valid descriptors of one stereo frame build, (N, 8) uint32."""
    f = build_stereo_frame_impl(torch.as_tensor(img_l, device=device),
                                torch.as_tensor(img_r, device=device),
                                torch.zeros((), device=device), CAM, BF, cfg)
    return f.desc[f.valid].cpu().numpy().view(np.uint32)


def harvest(device="cuda") -> np.ndarray:
    """The (N, 8) uint32 descriptor corpus of the six seeds."""
    pool = []
    for seed in range(SEEDS):
        for img_l, img_r in seed_frames(seed):
            pool.append(frame_descriptors(img_l, img_r, device))
        print(f"seed {seed}: corpus {sum(len(p) for p in pool)}", flush=True)
    return np.concatenate(pool)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--cpu", action="store_true", help="run on the host, not the card")
    args = ap.parse_args(argv)
    device = device_for(args.cpu)
    corpus = harvest(device)
    print(f"training on {len(corpus)} descriptors (b=10, d=4: 10^4 words)", flush=True)
    vocab = voc.train(corpus, branching=10, depth=4, seed=0, device=device)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    voc.save(vocab, args.out)
    print(f"saved {args.out} ({os.path.getsize(args.out)} bytes, "
          f"{vocab.weights.shape[0]} words)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
