"""Map and Atlas snapshots (port of orb_slam3_vio_fixes_tpu/slam_map/
snapshot.py).

A snapshot is one compressed .npz with the reference's layout, so a map
saved by either package loads in the other: the MapState fields under
`map_` (single map) or `act_` / `st{i}_` (Atlas: active and stored maps,
with their BoW histograms), a JSON `meta_json`, and the vocabulary with a
sha256 checksum that a load checks. Descriptors are stored as the
reference's uint32 words.
"""

from __future__ import annotations

import hashlib
import json
from typing import Optional

import numpy as np

from orb_slam3_vio_fixes_tpu_torch.convert import map_state_from_numpy, map_state_to_numpy
from orb_slam3_vio_fixes_tpu_torch.slam_map import map_state as ms
from orb_slam3_vio_fixes_tpu_torch.slam_map import vocabulary as voc_mod

FORMAT_VERSION = 1
ATLAS_FORMAT_VERSION = 2


class SnapshotError(RuntimeError):
    pass


def vocab_checksum(vocab) -> str:
    nodes, weights = voc_mod.to_numpy(vocab)
    h = hashlib.sha256()
    h.update(nodes.tobytes())
    h.update(weights.tobytes())
    return h.hexdigest()


def _vocab_arrays(vocab) -> dict:
    if vocab is None:
        return {}
    nodes, weights = voc_mod.to_numpy(vocab)
    return {"vocab_nodes": nodes, "vocab_weights": weights,
            "vocab_shape": np.array([vocab.branching, vocab.depth])}


def _meta(meta: dict) -> np.ndarray:
    return np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)


def _read_vocab(z, device):
    if "vocab_nodes" not in z:
        return None
    b, d = (int(x) for x in z["vocab_shape"])
    return voc_mod.from_numpy(z["vocab_nodes"], z["vocab_weights"], b, d, device)


def _check_vocab(vocab, meta):
    if vocab is not None and meta["vocab_checksum"] \
            and vocab_checksum(vocab) != meta["vocab_checksum"]:
        raise SnapshotError("vocabulary checksum mismatch: the snapshot was built "
                            "with a different vocabulary")


def save_map(path: str, state: ms.MapState, cfg: ms.MapConfig, n_kf: int, n_lm: int,
             vocab=None, extra: Optional[dict] = None):
    arrays = {f"map_{k}": v for k, v in map_state_to_numpy(state).items()}
    arrays["meta_json"] = _meta({
        "format_version": FORMAT_VERSION, "config": list(cfg), "n_kf": int(n_kf),
        "n_lm": int(n_lm),
        "vocab_checksum": vocab_checksum(vocab) if vocab is not None else "",
        "extra": extra or {}})
    arrays.update(_vocab_arrays(vocab))
    np.savez_compressed(path, **arrays)


def load_map(path: str, vocab=None, *, device):
    """(state, cfg, n_kf, n_lm, vocab or None, extra); a given `vocab` must
    match the snapshot's checksum."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["meta_json"]).decode())
        if meta["format_version"] != FORMAT_VERSION:
            raise SnapshotError(f"snapshot format {meta['format_version']} != "
                                f"{FORMAT_VERSION}")
        state = map_state_from_numpy({k: z[f"map_{k}"] for k in ms.MapState._fields},
                                     device)
        loaded_vocab = _read_vocab(z, device)
    _check_vocab(vocab, meta)
    return (state, ms.MapConfig(*meta["config"]), meta["n_kf"], meta["n_lm"],
            loaded_vocab, meta["extra"])


def save_atlas(path: str, state: ms.MapState, cfg: ms.MapConfig, n_kf: int, n_lm: int,
               kf_order, stored=(), hists=None, vocab=None,
               extra: Optional[dict] = None):
    """The whole Atlas: the active map, every stored map (atlas.StoredMap)
    with its histograms, the active histograms (K, W) and the counters."""
    arrays = {f"act_{k}": v for k, v in map_state_to_numpy(state).items()}
    if hists is not None:
        arrays["act_hists"] = np.asarray(
            hists.cpu().numpy() if hasattr(hists, "cpu") else hists)
    stored_meta = []
    for i, sm in enumerate(stored):
        for k, v in map_state_to_numpy(sm.state).items():
            arrays[f"st{i}_{k}"] = v
        arrays[f"st{i}_hists"] = np.asarray(sm.hists)
        stored_meta.append({"n_kf": int(sm.n_kf), "n_lm": int(sm.n_lm)})
    arrays["meta_json"] = _meta({
        "format_version": ATLAS_FORMAT_VERSION, "config": list(cfg), "n_kf": int(n_kf),
        "n_lm": int(n_lm), "kf_order": [int(k) for k in kf_order],
        "stored": stored_meta,
        "vocab_checksum": vocab_checksum(vocab) if vocab is not None else "",
        "extra": extra or {}})
    arrays.update(_vocab_arrays(vocab))
    np.savez_compressed(path, **arrays)


def load_atlas(path: str, vocab=None, *, device):
    """(state, cfg, meta, hists or None, stored, vocab or None), stored as
    (state, n_kf, n_lm, hists) tuples (atlas.StoredMap's fields)."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["meta_json"]).decode())
        if meta["format_version"] != ATLAS_FORMAT_VERSION:
            raise SnapshotError(f"atlas snapshot format {meta['format_version']} != "
                                f"{ATLAS_FORMAT_VERSION}")
        _check_vocab(vocab, meta)

        def read_state(prefix):
            return map_state_from_numpy(
                {k: z[f"{prefix}_{k}"] for k in ms.MapState._fields}, device)

        state = read_state("act")
        hists = np.array(z["act_hists"]) if "act_hists" in z else None
        stored = [(read_state(f"st{i}"), sm["n_kf"], sm["n_lm"],
                   np.array(z[f"st{i}_hists"])) for i, sm in enumerate(meta["stored"])]
        loaded_vocab = _read_vocab(z, device)
    return state, ms.MapConfig(*meta["config"]), meta, hists, stored, loaded_vocab
