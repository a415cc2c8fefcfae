"""IMU preintegration (port of orb_slam3_vio_fixes_tpu/imu/preintegration.py).

Midpoint integration of (dR, dV, dP), first-order bias Jacobians and the 9x9
covariance propagation of the reference's IMU::Preintegrated. The reference
runs a `lax.scan` over the samples and `vmap`s it over windows; here
`integrate` is one Python loop over the S samples whose every step works on
a leading batch of windows, so many windows cost the launches of one.

Padding convention: rows with dt = 0 leave the state unchanged (Exp(0) = I),
so fixed-capacity windows need no special casing.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from orb_slam3_vio_fixes_tpu_torch.utils import lie

GRAVITY = 9.81


@functools.lru_cache(maxsize=None)
def gravity_vec(device, dtype=torch.float32) -> torch.Tensor:
    """World gravity, cached per device (read-only): a host->device copy per
    call would synchronise the stream."""
    return torch.tensor([0.0, 0.0, -GRAVITY], dtype=dtype, device=device)


class ImuCalib(NamedTuple):
    """Discrete noise variances (gyro/acc white noise and random walk) and
    the body-from-camera extrinsics T_bc."""

    sigma2_gyro: float
    sigma2_acc: float
    sigma2_gyro_walk: float
    sigma2_acc_walk: float
    R_bc: torch.Tensor          # (3, 3)
    t_bc: torch.Tensor          # (3,)

    @staticmethod
    def make(noise_gyro, noise_acc, walk_gyro, walk_acc, freq, R_bc=None, t_bc=None,
             *, device) -> "ImuCalib":
        """From continuous-time densities and the sample rate
        (sigma_discrete = sigma_cont * sqrt(freq)), rounded to float32 as the
        reference's scalars are."""
        import numpy as np

        sf = float(freq)
        f = lambda x: float(np.float32(x))  # noqa: E731
        dev = torch.device(device)
        R = (torch.eye(3, device=dev) if R_bc is None
             else torch.as_tensor(np.asarray(R_bc, np.float32), device=dev))
        t = (torch.zeros(3, device=dev) if t_bc is None
             else torch.as_tensor(np.asarray(t_bc, np.float32), device=dev))
        return ImuCalib(f(noise_gyro ** 2 * sf), f(noise_acc ** 2 * sf),
                        f(walk_gyro ** 2 / sf), f(walk_acc ** 2 / sf), R, t)

    def cam_from_body(self):
        """(R_cb, t_cb): camera-from-body extrinsics."""
        R_cb = self.R_bc.T
        return R_cb, -(R_cb @ self.t_bc)


class Preintegrated(NamedTuple):
    """Preintegrated deltas between two frames / keyframes at the
    linearisation bias (bg0, ba0); every field may carry leading batch
    dimensions."""

    dT: torch.Tensor        # () total time
    dR: torch.Tensor        # (3, 3)
    dV: torch.Tensor        # (3,)
    dP: torch.Tensor        # (3,)
    JRg: torch.Tensor       # (3, 3) d dR / d bg
    JVg: torch.Tensor
    JVa: torch.Tensor
    JPg: torch.Tensor
    JPa: torch.Tensor
    cov: torch.Tensor       # (9, 9) covariance of (phi, v, p)
    cov_walk: torch.Tensor  # (6, 6) bias random-walk covariance
    bg0: torch.Tensor       # (3,)
    ba0: torch.Tensor       # (3,)

    @staticmethod
    def identity(bg0: torch.Tensor, ba0: torch.Tensor) -> "Preintegrated":
        """Identity deltas with the batch shape of the biases (..., 3)."""
        batch = bg0.shape[:-1]
        dev, dt = bg0.device, bg0.dtype
        z = lambda *s: torch.zeros(batch + s, dtype=dt, device=dev)  # noqa: E731
        eye = torch.eye(3, dtype=dt, device=dev).expand(batch + (3, 3)).clone()
        return Preintegrated(z(), eye, z(3), z(3), z(3, 3), z(3, 3), z(3, 3),
                             z(3, 3), z(3, 3), z(9, 9), z(6, 6), bg0, ba0)


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


@functools.lru_cache(maxsize=None)
def _noise_diag(a: float, b: float, device) -> torch.Tensor:
    return torch.tensor([a, a, a, b, b, b], dtype=torch.float32, device=device)


def _step(s: Preintegrated, sample: torch.Tensor, calib: ImuCalib,
          nga: torch.Tensor, walk: torch.Tensor) -> Preintegrated:
    """One midpoint-integration update (reference: IntegrateNewMeasurement)."""
    acc, gyro, dt = sample[..., :3], sample[..., 3:6], sample[..., 6]
    a = acc - s.ba0
    w = gyro - s.bg0
    dt1 = dt[..., None]
    dt2 = dt1 * dt1
    dt3 = dt1[..., None]
    Ra = _mv(s.dR, a)
    dP = s.dP + s.dV * dt1 + 0.5 * Ra * dt2
    dV = s.dV + Ra * dt1

    a_hat = lie.hat(a)
    wdt = w * dt1
    dRi = lie.so3_exp(wdt)
    Jr = lie.so3_right_jacobian(wdt)
    R_ahat = s.dR @ a_hat
    eye3 = torch.eye(3, dtype=a.dtype, device=a.device).expand(s.dR.shape)
    zero3 = torch.zeros_like(s.dR)

    # A (9x9) and B (9x6) of the reference's covariance propagation
    A = torch.cat([
        torch.cat([dRi.transpose(-1, -2), zero3, zero3], -1),
        torch.cat([-R_ahat * dt3, eye3, zero3], -1),
        torch.cat([-0.5 * R_ahat * dt3 * dt3, eye3 * dt3, eye3], -1)], -2)
    B = torch.cat([
        torch.cat([Jr * dt3, zero3], -1),
        torch.cat([zero3, s.dR * dt3], -1),
        torch.cat([zero3, 0.5 * s.dR * dt3 * dt3], -1)], -2)
    At = A.transpose(-1, -2)
    cov = A @ s.cov @ At + (B * nga) @ B.transpose(-1, -2)
    cov_walk = s.cov_walk + torch.diag_embed(walk * dt1)

    # bias Jacobians, reference order: JP before JV before JR, all with the
    # pre-update dR
    R_ahat_JRg = R_ahat @ s.JRg
    JPg = s.JPg + s.JVg * dt3 - 0.5 * R_ahat_JRg * dt3 * dt3
    JPa = s.JPa + s.JVa * dt3 - 0.5 * s.dR * dt3 * dt3
    JVg = s.JVg - R_ahat_JRg * dt3
    JVa = s.JVa - s.dR * dt3
    JRg = dRi.transpose(-1, -2) @ s.JRg - Jr * dt3
    return Preintegrated(s.dT + dt, s.dR @ dRi, dV, dP, JRg, JVg, JVa, JPg, JPa,
                         cov, cov_walk, s.bg0, s.ba0)


def integrate(samples: torch.Tensor, bias_g: torch.Tensor, bias_a: torch.Tensor,
              calib: ImuCalib) -> Preintegrated:
    """Integrate windows of IMU samples.

    samples: (..., S, 7) rows (ax, ay, az, gx, gy, gz, dt), padded rows with
    dt = 0; bias_g / bias_a: (..., 3) linearisation biases (broadcast over
    the window batch)."""
    batch = samples.shape[:-2]
    bg = bias_g.expand(batch + (3,))
    ba = bias_a.expand(batch + (3,))
    dev = samples.device
    nga = _noise_diag(calib.sigma2_gyro, calib.sigma2_acc, dev)
    walk = _noise_diag(calib.sigma2_gyro_walk, calib.sigma2_acc_walk, dev)
    s = Preintegrated.identity(bg, ba)
    for i in range(samples.shape[-2]):
        s = _step(s, samples[..., i, :], calib, nga, walk)
    # renormalise the accumulated rotation (the reference does each step)
    return s._replace(dR=lie.so3_normalize(s.dR))


def delta_rotation(p: Preintegrated, bg: torch.Tensor) -> torch.Tensor:
    """Bias-corrected dR (reference: GetDeltaRotation)."""
    return p.dR @ lie.so3_exp(_mv(p.JRg, bg - p.bg0))


def delta_velocity(p: Preintegrated, bg, ba) -> torch.Tensor:
    return p.dV + _mv(p.JVg, bg - p.bg0) + _mv(p.JVa, ba - p.ba0)


def delta_position(p: Preintegrated, bg, ba) -> torch.Tensor:
    return p.dP + _mv(p.JPg, bg - p.bg0) + _mv(p.JPa, ba - p.ba0)


def merge(a: Preintegrated, b: Preintegrated) -> Preintegrated:
    """Concatenate two consecutive preintegrations at a's linearisation bias
    (reference: MergePrevious); b is re-linearised to a's bias to first
    order."""
    dRb = delta_rotation(b, a.bg0)
    dVb = delta_velocity(b, a.bg0, a.ba0)
    dPb = delta_position(b, a.bg0, a.ba0)
    bdT = b.dT[..., None, None]
    dR = a.dR @ dRb
    dV = a.dV + _mv(a.dR, dVb)
    dP = a.dP + a.dV * b.dT[..., None] + _mv(a.dR, dPb)
    JRg = dRb.transpose(-1, -2) @ a.JRg + b.JRg
    JVg = a.JVg + a.dR @ b.JVg - a.dR @ lie.hat(dVb) @ a.JRg
    JVa = a.JVa + a.dR @ b.JVa
    JPg = a.JPg + a.JVg * bdT + a.dR @ b.JPg - a.dR @ lie.hat(dPb) @ a.JRg
    JPa = a.JPa + a.JVa * bdT + a.dR @ b.JPa
    eye3 = torch.eye(3, dtype=a.dR.dtype, device=a.dR.device).expand(a.dR.shape)
    zero3 = torch.zeros_like(a.dR)
    A = torch.cat([
        torch.cat([dRb.transpose(-1, -2), zero3, zero3], -1),
        torch.cat([-a.dR @ lie.hat(dVb), eye3, zero3], -1),
        torch.cat([-a.dR @ lie.hat(dPb), eye3 * bdT, eye3], -1)], -2)
    Bm = torch.cat([
        torch.cat([eye3, zero3, zero3], -1),
        torch.cat([zero3, a.dR, zero3], -1),
        torch.cat([zero3, zero3, a.dR], -1)], -2)
    cov = (A @ a.cov @ A.transpose(-1, -2)
           + Bm @ b.cov @ Bm.transpose(-1, -2))
    return Preintegrated(a.dT + b.dT, dR, dV, dP, JRg, JVg, JVa, JPg, JPa, cov,
                         a.cov_walk + b.cov_walk, a.bg0, a.ba0)


def predict_state(R_wb, p_wb, v_w, bg, ba, pre: Preintegrated):
    """Dead-reckon the next body state (reference: PredictStateIMU).
    Returns (R_wb2, p_wb2, v_w2)."""
    dt = pre.dT[..., None]
    g = gravity_vec(v_w.device, v_w.dtype)
    dR = delta_rotation(pre, bg)
    dV = delta_velocity(pre, bg, ba)
    dP = delta_position(pre, bg, ba)
    R2 = R_wb @ dR
    v2 = v_w + g * dt + _mv(R_wb, dV)
    p2 = p_wb + v_w * dt + 0.5 * g * dt * dt + _mv(R_wb, dP)
    return lie.so3_normalize(R2), p2, v2
