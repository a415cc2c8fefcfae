"""Train a BoW vocabulary from a directory of images (the port's twin of
scripts/train_vocabulary.py).

ORB descriptors of every image (`ops/orb.extract`: one B = 1 pyramid atlas
per image through the FAST kernel) train a hierarchical k-medians
vocabulary (`slam_map/vocabulary.train`), saved as .npz in the layout both
packages read, for any app's --vocab.

    python -m orb_slam3_vio_fixes_tpu_torch.scripts.train_vocabulary \
        IMG_DIR OUT.npz [--branching 10] [--depth 4] [--max-images 300] \
        [--features 1000] [--cpu]

Image files are read through imageio or PIL, whichever is installed; with
neither, `load_gray` raises. `train_from_images` takes images in memory.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from orb_slam3_vio_fixes_tpu_torch.ops import orb
from orb_slam3_vio_fixes_tpu_torch.scripts import device_for
from orb_slam3_vio_fixes_tpu_torch.slam_map import vocabulary as voc

EXTS = (".png", ".jpg", ".jpeg", ".pgm", ".bmp")


def load_gray(path):
    """(H, W) float32 gray image of a file, read by imageio or else PIL."""
    try:
        import imageio.v3 as iio

        img = iio.imread(path)
    except ImportError:
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError("train_vocabulary reads image files through imageio or "
                              "PIL, and neither is installed; pass images in memory "
                              "to train_from_images instead") from e
        img = np.asarray(Image.open(path))
    if img.ndim == 3:
        img = img @ np.array([0.299, 0.587, 0.114], np.float32)
    return img.astype(np.float32)


def image_paths(img_dir: str, max_images: int) -> list:
    """The directory's image files in name order, subsampled evenly to at
    most `max_images`."""
    paths = sorted(os.path.join(img_dir, f) for f in os.listdir(img_dir)
                   if f.lower().endswith(EXTS))
    step = max(1, len(paths) // max_images)
    return paths[::step][:max_images]


def corpus_of(images, features: int = 1000, device="cuda") -> np.ndarray:
    """The valid ORB descriptors of every (H, W) image, (N, 8) uint32."""
    cfg = orb.ORBConfig(n_features=features)
    all_desc = []
    for i, img in enumerate(images):
        f = orb.extract(torch.as_tensor(np.asarray(img, np.float32), device=device), cfg)
        all_desc.append(f.desc[f.valid].cpu().numpy().view(np.uint32))
        if (i + 1) % 25 == 0:
            print(f"  {i + 1}/{len(images)} images, "
                  f"{sum(len(x) for x in all_desc)} descriptors", flush=True)
    return np.concatenate(all_desc)


def train_from_images(images, branching: int = 10, depth: int = 4, features: int = 1000,
                      device="cuda") -> voc.Vocabulary:
    """A branching^depth vocabulary over the images' descriptors, on
    `device`."""
    descs = corpus_of(images, features, device)
    print(f"training {branching}^{depth} vocabulary on {len(descs)} descriptors ...",
          flush=True)
    return voc.train(descs, branching=branching, depth=depth, device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("img_dir")
    ap.add_argument("out")
    ap.add_argument("--branching", type=int, default=10)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--max-images", type=int, default=300)
    ap.add_argument("--features", type=int, default=1000)
    ap.add_argument("--cpu", action="store_true", help="run on the host, not the card")
    args = ap.parse_args(argv)
    device = device_for(args.cpu)

    paths = image_paths(args.img_dir, args.max_images)
    if not paths:
        sys.exit(f"no images found in {args.img_dir}")
    v = train_from_images([load_gray(p) for p in paths], args.branching, args.depth,
                          args.features, device)
    voc.save(v, args.out)
    print(f"saved {v.n_words}-word vocabulary to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
