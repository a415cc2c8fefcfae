"""Binary bag-of-words vocabulary and the dense keyframe database (port of
orb_slam3_vio_fixes_tpu/slam_map/vocabulary.py).

The tree is a complete b-ary heap of (n_nodes, 8) descriptor words; a
descriptor descends `depth` rounds of b-way XOR + popcount argmin (torch has
no popcount: the SWAR `matching.popcount32`). The inverted file is a dense
(K, W) histogram matrix, so a query scores every keyframe in one L1
reduction. Descriptors and nodes are int32 bit patterns of the reference's
uint32 words. Training (hierarchical k-medians) is numpy, as in the
reference; its inverse-document weights go through `assign_words` on the
device the caller names.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from orb_slam3_vio_fixes_tpu_torch.ops.matching import popcount32
from orb_slam3_vio_fixes_tpu_torch.utils.linalg import topk_stable

# The checked-in vocabulary artifacts live in the reference package's asset
# folder; the port reads them by path (a data read, not an import).
ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "orb_slam3_vio_fixes_tpu", "assets")


class Vocabulary(NamedTuple):
    """nodes: (n_nodes, 8) int32 centroids in heap order, children(i) =
    i*b + 1 + k, root unused at 0; weights: (b^depth,) float32 idf."""

    nodes: torch.Tensor
    weights: torch.Tensor
    branching: int
    depth: int

    @property
    def n_words(self) -> int:
        return self.branching ** self.depth


def _popcount_np(x: np.ndarray) -> np.ndarray:
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)


def _majority_centroid(descs: np.ndarray) -> np.ndarray:
    """Bitwise majority of (N, 8) uint32 descriptors."""
    bits = np.unpackbits(descs.view(np.uint8), axis=-1)
    maj = (bits.sum(0) * 2 >= bits.shape[0]).astype(np.uint8)
    return np.packbits(maj).view(np.uint32)


def _kmedians(descs: np.ndarray, k: int, rng, n_iter: int = 8) -> np.ndarray:
    """Binary k-medians under the Hamming distance: (k, 8) centroids."""
    n = descs.shape[0]
    if n == 0:
        return np.zeros((k, 8), np.uint32)
    centroids = descs[rng.choice(n, size=min(k, n), replace=False)]
    if centroids.shape[0] < k:
        centroids = np.concatenate(
            [centroids, descs[rng.integers(0, n, k - centroids.shape[0])]])
    for _ in range(n_iter):
        assign = _popcount_np(descs[:, None, :] ^ centroids[None, :, :]).argmin(1)
        new = []
        for c in range(k):
            sel = descs[assign == c]
            new.append(descs[rng.integers(0, n)] if len(sel) == 0
                       else _majority_centroid(sel))
        centroids = np.stack(new)
    return centroids


def train(descs: np.ndarray, branching: int = 10, depth: int = 3, seed: int = 0,
          idf: bool = True, *, device) -> Vocabulary:
    """Hierarchical k-medians over (N, 8) uint32 (or int32 bit-pattern)
    descriptors on the host, the same tree as the reference for the same
    seed; the inverse-document weights count `assign_words` on `device`,
    where the vocabulary is returned."""
    descs = np.ascontiguousarray(descs).view(np.uint32)
    rng = np.random.default_rng(seed)
    n_nodes = sum(branching ** (lv + 1) for lv in range(depth))
    nodes = np.zeros((1 + n_nodes, 8), np.uint32)

    def split(node_idx: int, level: int, subset: np.ndarray):
        if level == depth:
            return
        cents = _kmedians(subset, branching, rng)
        if len(subset):
            assign = _popcount_np(subset[:, None, :] ^ cents[None, :, :]).argmin(1)
        else:
            assign = np.zeros(0, int)
        for c in range(branching):
            child = node_idx * branching + 1 + c
            nodes[child] = cents[c]
            split(child, level + 1, subset[assign == c] if len(subset) else subset)

    split(0, 0, descs)
    n_words = branching ** depth
    weights = np.ones(n_words, np.float32)
    if idf and len(descs):
        tmp = from_numpy(nodes, np.ones(n_words, np.float32), branching, depth, device)
        d = torch.as_tensor(descs.view(np.int32), device=device)
        words = assign_words(tmp, d, torch.ones(len(descs), dtype=torch.bool,
                                                device=device)).cpu().numpy()
        counts = np.bincount(words[words >= 0], minlength=n_words).astype(np.float32)
        weights = np.log(len(descs) / np.maximum(counts, 1.0)).astype(np.float32)
        weights = np.maximum(weights, 1e-3)
    return from_numpy(nodes, weights, branching, depth, device)


def from_numpy(nodes, weights, branching: int, depth: int, device) -> Vocabulary:
    """A vocabulary from the reference's arrays (uint32 nodes)."""
    nodes = np.ascontiguousarray(nodes).view(np.int32)
    return Vocabulary(torch.as_tensor(np.array(nodes), device=device),
                      torch.as_tensor(np.array(weights, np.float32), device=device),
                      int(branching), int(depth))


def to_numpy(vocab: Vocabulary):
    """(uint32 nodes, float32 weights) as the reference stores them."""
    return (vocab.nodes.cpu().numpy().view(np.uint32),
            vocab.weights.cpu().numpy())


def save(vocab: Vocabulary, path: str) -> None:
    """Write the reference's .npz layout (uint32 nodes, float32 weights,
    int32 branching and depth), which the reference's `load` reads."""
    nodes, weights = to_numpy(vocab)
    np.savez_compressed(path, nodes=nodes, weights=weights,
                        branching=np.int32(vocab.branching), depth=np.int32(vocab.depth))


def load(path: str, device) -> Vocabulary:
    with np.load(path) as z:
        return from_numpy(z["nodes"], z["weights"], int(z["branching"]),
                          int(z["depth"]), device)


def default_vocabulary(device) -> Vocabulary:
    """The checked-in 10^5-word b10d5 artifact, else the 10^4-word b10d4."""
    large = os.path.join(ASSET_DIR, "vocab_b10d5.npz")
    if os.path.exists(large):
        return load(large, device)
    return load(os.path.join(ASSET_DIR, "vocab_b10d4.npz"), device)


def assign_words(vocab: Vocabulary, descs: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """(N, 8) descriptors -> (N,) int64 leaf word ids (-1 where invalid):
    all N descend in lockstep, one b-way argmin per level (first index on
    ties, as jnp.argmin)."""
    b, d = vocab.branching, vocab.depth
    n = descs.shape[0]
    dev = descs.device
    ar = torch.arange(b, device=dev)
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    for _ in range(d):
        child0 = node * b + 1
        cand = vocab.nodes[child0[:, None] + ar[None, :]]           # (N, b, 8)
        dist = popcount32(cand ^ descs[:, None, :]).sum(-1)         # (N, b)
        node = child0 + torch.argmin(dist, dim=-1)
    word = node - (b ** d - 1) // (b - 1)
    return torch.where(valid, word, torch.full_like(word, -1))


def bow_histogram(vocab: Vocabulary, words: torch.Tensor) -> torch.Tensor:
    """(N,) word ids -> (W,) L1-normalised tf-idf histogram."""
    W = vocab.weights.shape[0]
    ok = words >= 0
    w = words.clamp(0, W - 1)
    h = torch.zeros(W, device=words.device).index_add_(
        0, w, torch.where(ok, vocab.weights[w], torch.zeros((), device=words.device)))
    return h / torch.clamp(h.abs().sum(), min=1e-9)


def l1_score(h_query: torch.Tensor, h_db: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 similarity 1 - |q - d|_1 / 2 against each row of (K, W)."""
    return 1.0 - 0.5 * (h_query[None, :] - h_db).abs().sum(-1)


class KeyFrameDatabase(NamedTuple):
    """Dense BoW database over keyframe slots: (K, W) histograms, zero rows
    absent. Updated in place by `db_add`."""

    hist: torch.Tensor

    @staticmethod
    def empty(max_kf: int, n_words: int, device) -> "KeyFrameDatabase":
        return KeyFrameDatabase(torch.zeros((max_kf, n_words), device=device))


def db_add(db: KeyFrameDatabase, kf_id: int, hist: torch.Tensor) -> KeyFrameDatabase:
    db.hist[int(kf_id)] = hist
    return db


def _scores(db: KeyFrameDatabase, h_query):
    """L1 scores and the empty-row mask (an empty row would score 0.5)."""
    return l1_score(h_query, db.hist), db.hist.abs().sum(-1) < 1e-9


def db_query(db: KeyFrameDatabase, h_query, exclude, min_score: float,
             n_best: int = 3):
    """Top-N candidates by L1 score, exclusions and empty rows masked.
    Returns (ids (n_best,) int64, -1 below min_score; scores (n_best,))."""
    scores, empty = _scores(db, h_query)
    scores = torch.where(exclude | empty, torch.full_like(scores, -1.0), scores)
    top_s, top_i = topk_stable(scores, n_best)
    return torch.where(top_s >= min_score, top_i, torch.full_like(top_i, -1)), top_s


def db_query_grouped(db: KeyFrameDatabase, h_query, cov, exclude, min_score: float,
                     n_best: int = 3, group_size: int = 10):
    """DetectNBestCandidates with covisibility-group accumulation (the
    reference's max-dominant group score: best member, then a 1e-3 damped sum
    of the rest; candidates below 0.8x the best hit or min_score, and groups
    below 0.75x the best group, drop out). cov: (K, K) float shared-point
    counts. Returns (ids (n_best,), -1 where gated; scores (n_best,))."""
    K = cov.shape[0]
    dev = cov.device
    zero = torch.zeros((), device=dev)
    scores, empty = _scores(db, h_query)
    own = torch.where(exclude | empty, zero, torch.clamp(scores, min=0.0))
    strong = own >= torch.clamp(0.8 * own.max(), min=min_score)
    own_s = torch.where(strong, own, zero)
    topw, _ = topk_stable(cov, min(group_size, K))
    thresh = torch.clamp(topw[:, -1:], min=1.0)
    nbmask = (cov >= thresh) & (cov > 0)
    members = nbmask | torch.eye(K, dtype=torch.bool, device=dev)
    group_max = torch.where(members, own_s[None, :], zero).max(-1).values
    acc_sum = own_s + nbmask.to(own.dtype) @ own_s
    acc = group_max + 1e-3 * torch.clamp(acc_sum - group_max, min=0.0)
    acc = torch.where(strong, acc, torch.full_like(acc, -1.0))
    acc = torch.where(acc >= 0.75 * acc.max(), acc, torch.full_like(acc, -1.0))
    top_s, top_i = topk_stable(acc, n_best)
    return torch.where(top_s > 0, top_i, torch.full_like(top_i, -1)), top_s
