"""Carry state across from the JAX package: its MapState, Camera and
FrameData fields, taken as numpy arrays, into the port's tensors and back.

The reference's uint32 descriptor words become int32 bit patterns (torch's
uint32 support is thin); the conversion back restores uint32.
"""

from __future__ import annotations

import numpy as np
import torch

from orb_slam3_vio_fixes_tpu_torch.frontend.frame import FrameData
from orb_slam3_vio_fixes_tpu_torch.slam_map.map_state import MapState
from orb_slam3_vio_fixes_tpu_torch.utils.cameras import Camera

_DESC_FIELDS = ("kf_desc", "lm_desc", "desc")


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.as_tensor(np.array(a, order="C"), device=device)


def _to_numpy(name: str, t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    if name in _DESC_FIELDS:
        a = a.view(np.uint32)
    return a


def map_state_from_numpy(fields: dict, device) -> MapState:
    """{field name: numpy array} of the JAX MapState -> the port's MapState."""
    return MapState(**{f: _to_tensor(fields[f], device)
                       for f in MapState._fields})


def map_state_to_numpy(state: MapState) -> dict:
    return {f: _to_numpy(f, getattr(state, f)) for f in MapState._fields}


def camera_from_numpy(fx, fy, cx, cy, dist=(0.0, 0.0, 0.0, 0.0), kind=0) -> Camera:
    """Camera from the JAX Camera's leaves (scalars / a (4,) array)."""
    base = Camera.pinhole(fx, fy, cx, cy)
    return base._replace(dist=tuple(float(np.float32(d)) for d in np.ravel(dist)),
                         kind=int(kind))


def frame_from_numpy(fields: dict, device) -> FrameData:
    """{field name: numpy array} of the JAX FrameData -> the port's."""
    return FrameData(**{f: _to_tensor(fields[f], device)
                        for f in FrameData._fields})
