"""Carry state across from the JAX package: its MapState, Camera, FrameData
and inertial types (ImuCalib, Preintegrated, BodyState, the VIProblem
leaves), their fields taken as numpy arrays, into the port's tensors and
back.

The reference's uint32 descriptor words become int32 bit patterns (torch's
uint32 support is thin); the conversion back restores uint32. Index fields
become int64, the port's index type.
"""

from __future__ import annotations

import numpy as np
import torch

from orb_slam3_vio_fixes_tpu_torch.frontend.frame import FrameData
from orb_slam3_vio_fixes_tpu_torch.frontend.inertial_tracking import BodyState
from orb_slam3_vio_fixes_tpu_torch.imu.preintegration import ImuCalib, Preintegrated
from orb_slam3_vio_fixes_tpu_torch.optim import vi_ba
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


def fields_from_numpy(cls, fields: dict, device, index=()):
    """A NamedTuple `cls` of tensors from {field name: numpy array}; the
    `index` fields become int64."""
    return cls(**{f: (_to_tensor(fields[f], device).to(torch.int64) if f in index
                      else _to_tensor(fields[f], device)) for f in cls._fields})


def imu_calib_from_numpy(fields: dict, device) -> ImuCalib:
    """The JAX ImuCalib's leaves -> the port's (variances as float32-rounded
    Python floats, extrinsics as tensors)."""
    return ImuCalib(*(float(np.float32(fields[f])) for f in ImuCalib._fields[:4]),
                    _to_tensor(fields["R_bc"], device), _to_tensor(fields["t_bc"], device))


def preintegrated_from_numpy(fields: dict, device) -> Preintegrated:
    return fields_from_numpy(Preintegrated, fields, device)


def body_state_from_numpy(fields: dict, device) -> BodyState:
    return fields_from_numpy(BodyState, fields, device)


def vi_problem_from_numpy(states: dict, lm, lm_valid, lm_fixed, reproj: dict,
                          inertial: dict, prior: dict, cam: Camera, bf, R_cb, t_cb,
                          device) -> vi_ba.VIProblem:
    """A VIProblem from the JAX one's leaves (each sub-tuple as a dict)."""
    prior = dict(prior)
    return vi_ba.VIProblem(
        states=fields_from_numpy(vi_ba.VIStates, states, device),
        lm=_to_tensor(lm, device), lm_valid=_to_tensor(lm_valid, device),
        lm_fixed=_to_tensor(lm_fixed, device),
        reproj=fields_from_numpy(vi_ba.VIReprojFactors, reproj, device,
                       index=("state_idx", "lm_idx")),
        inertial=fields_from_numpy(vi_ba.VIInertialFactors, inertial, device,
                         index=("idx_i", "idx_j")),
        prior=vi_ba.VIPrior(
            state_idx=int(prior.pop("state_idx")), valid=bool(prior.pop("valid")),
            **{f: _to_tensor(a, device) for f, a in prior.items()}),
        cam=cam, bf=float(np.float32(bf)), R_cb=_to_tensor(R_cb, device),
        t_cb=_to_tensor(t_cb, device))
