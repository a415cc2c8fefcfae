"""What decides `correct`: what the timed path produced, held against the
plain references of `slam_bench/reference/`.

During the window the recorders keep, for frames and matcher calls drawn
from the seed, what the program produced and what it was given: the atlas
that the frame build handed to kernel K1 and K1's scores, the frame's left
features, and the inputs and outputs of kernel K2. Every pose the window
returned is kept, and the keyframe poses that the map holds once the
window has closed. After the window, with the program's state freed, the
references work out the same things again and the numbers below compare
them:

- `atlas_err`: grey levels, the largest gap between the program's pyramid
  atlas and the reference's, made from the raw images;
- `k1_bad`: pixels where K1's FAST score differs from the reference's on
  the same atlas;
- `feat_bad`: left-image features whose validity, pixel, level or BRIEF
  bits differ from the reference's selection and description on that
  atlas, or whose angle differs by more than ANGLE_TOL;
- `k2_bad`: output elements of K2 that differ from the reference best-2 on
  the same descriptors and mask;
- `ate_m`: metres, the largest Horn-aligned ATE (the RMS camera-centre
  error after the best rigid alignment) over the window's consecutive
  segments of `segment_frames` tracked frames, against the generator's
  truth: every pose the window returned, judged in pieces of a fixed
  length, so that the number does not grow with the frames a faster run
  tracks;
- `kf_ate_m`: the same over segments of `segment_keyframes` consecutive
  keyframes of the map the window left (after its bundle adjustments);
- the inertial state of the keyframes the window made, after the window
  BAs, against the generator's: `kf_vel_err` (m/s, the largest error of a
  velocity, taken in the keyframe's camera frame), `kf_bg_err` (rad/s) and
  `kf_ba_err` (m/s^2), the largest errors of the gyroscope and
  accelerometer biases, and `gravity_deg`, the largest angle by which a
  keyframe's vertical in the map (whose world the IMU initialisation turns
  to put gravity along -z) misses the true one, seen from the camera.

A cell compares the numbers its `limits` name. The control stands the
references in the program's place at the next precision below the
configuration's: images at 4 bits instead of uint8 for everything derived
from them, descriptor bytes at 4 bits instead of 8, and the true poses,
velocities and biases rounded to bfloat16 instead of float32. Beside it,
faults are planted in the truth put in the program's place (`FAULTS`), for
the readings that the trajectory's and the inertial numbers' limits are
set below.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from slam_bench.reference import frame as ref_frame
from slam_bench.reference import hamming as ref_hamming
from slam_bench.reference import trajectory as ref_traj

ANGLE_TOL = 1e-4       # radians; a thousandth of a BRIEF rotation bin
NUMBERS = ("atlas_err", "k1_bad", "feat_bad", "k2_bad", "ate_m", "kf_ate_m", "kf_vel_err",
           "kf_bg_err", "kf_ba_err", "gravity_deg")
FAULT_SHIFT_M = 0.2    # pose_altered: every other pose moved this far along its x axis


def draw(seed: int, k: int, within: int) -> list:
    """k distinct positions in [0, within), drawn from the seed."""
    rng = np.random.default_rng([seed, 0x5EED])
    return sorted(int(x) for x in rng.choice(within, size=min(k, within), replace=False))


class Recorder:
    """Keeps the frame build's and K2's inputs and outputs for the drawn
    scene frames and matcher calls; `frame` is the scene frame being
    tracked (None outside the window)."""

    def __init__(self, frames, k2_calls):
        self.frames = set(frames)
        self.k2_calls = set(k2_calls)
        self.frame = None
        self.k2_seen = 0
        self.built = {}      # scene frame -> dict(atlas, scores, uv, octave, angle, desc, valid)
        self.k2 = []         # (dq, dt, mask, cols, outputs)
        self._in_build = False

    @contextlib.contextmanager
    def installed(self):
        from orb_slam3_vio_fixes_tpu_torch.frontend import tracking
        from orb_slam3_vio_fixes_tpu_torch.ops import fast, matching

        build, k1 = tracking.build_stereo_frame_impl, fast.fast_score_batch
        k2 = matching.hamming_match

        def build_rec(*a, **k):
            want = self.frame in self.frames and self.frame not in self.built
            self._in_build = want
            try:
                out = build(*a, **k)
            finally:
                self._in_build = False
            if want:
                rec = self.built.setdefault(self.frame, {})
                for name in ("uv", "octave", "angle", "desc", "valid"):
                    rec[name] = getattr(out, name).clone()
            return out

        def k1_rec(atlas):
            scores = k1(atlas)
            if self._in_build:
                self.built[self.frame] = {"atlas": atlas.clone(), "scores": scores.clone()}
            return scores

        def k2_rec(desc_q, desc_t, mask, cols):
            out = k2(desc_q, desc_t, mask, cols)
            if self.frame is not None:
                if self.k2_seen in self.k2_calls:
                    self.k2.append((desc_q.clone(), desc_t.clone(), mask.clone(), cols,
                                    tuple(None if o is None else o.clone() for o in out)))
                self.k2_seen += 1
            return out

        tracking.build_stereo_frame_impl = build_rec
        fast.fast_score_batch = k1_rec
        matching.hamming_match = k2_rec
        try:
            yield self
        finally:
            tracking.build_stereo_frame_impl = build
            fast.fast_score_batch = k1
            matching.hamming_match = k2


KF_FIELDS = ("ts", "R", "t", "vel", "bg", "ba")


def keyframes(tracker) -> dict:
    """The map's keyframes in time order, on the host in float64: their
    times, poses (R_cw, t_cw), world velocities and biases."""
    st = tracker.state
    idx = torch.as_tensor(list(tracker.kf_order), dtype=torch.int64, device=st.kf_R.device)
    kf = {k: getattr(st, "kf_" + k)[idx].cpu().numpy().astype(np.float64) for k in KF_FIELDS}
    o = np.argsort(kf["ts"], kind="stable")
    return {k: v[o] for k, v in kf.items()}


# -- the references' readings --

def _quant4(x: torch.Tensor) -> torch.Tensor:
    """Grey levels held in 4 bits: the upper nibble, centred."""
    return torch.floor(x.to(torch.float32) / 16.0) * 16.0 + 8.0


def reference_features(atlas, scores, shape, orb, angle=None, patch_atlas=None):
    """The reference's (uv, octave, angle, bits, valid) of eye 0 of a
    (2, total_h, W) atlas and its FAST scores; orientation and BRIEF read
    the blurred `patch_atlas` (default: the atlas) in bfloat16, BRIEF
    steered by `angle` when given (the program's), else by the reference's
    own."""
    ay, ax, valid, octave = ref_frame.select(scores, shape, orb)
    src = atlas if patch_atlas is None else patch_atlas
    p = ref_frame.patches(ref_frame.blur(src).to(torch.bfloat16), ay, ax)
    ang = ref_frame.orientation(p)
    bits = ref_frame.describe(p[:1], ang[:1] if angle is None else angle[None])[0]
    return (ref_frame.keypoint_uv(ay, ax, octave, shape, orb)[0], octave[0], ang[0], bits,
            valid[0])


def atlas_err(imgs, atlas, orb) -> float:
    ref = ref_frame.atlas(imgs, orb["nLevels"], orb["scaleFactor"], 35)
    return float((atlas - ref).abs().max())


def k1_bad(atlas, scores) -> int:
    return int((ref_frame.fast_score(atlas) != scores).sum())


def feat_bad(atlas, feat: dict, shape, orb) -> int:
    """Features of eye 0 that differ from the reference's selection and
    description on `atlas`, BRIEF steered by the features' own angles."""
    uv, octave, ang, bits, valid = reference_features(
        atlas, ref_frame.fast_score(atlas), shape, orb, feat["angle"])
    d_ang = torch.remainder(feat["angle"] - ang + math.pi, 2 * math.pi) - math.pi
    bits_f = feat["bits"] if "bits" in feat else ref_frame.unpack_bits(feat["desc"])
    same = ((feat["uv"] == uv).all(-1) & (feat["octave"] == octave)
            & (d_ang.abs() <= ANGLE_TOL) & (bits_f == bits).all(-1))
    return int(((feat["valid"] != valid) | (valid & ~same)).sum())


def k2_bad(calls) -> int:
    bad = 0
    for dq, dt, mask, cols, out in calls:
        ref = ref_hamming.best2(dq, dt, mask, cols)
        for a, b in zip(out, ref):
            if b is not None:
                bad += int((a != b).sum())
    return bad


def segment_ate(R_cw, t_cw, t_wc_true, seg: int, use=None) -> float:
    """The largest Horn-aligned ATE over consecutive segments of `seg` of the
    used poses (a last, shorter segment of at least 3 counts too); NaN when
    none has 3."""
    C = -(np.transpose(R_cw, (0, 2, 1)) @ np.asarray(t_cw)[..., None])[..., 0]
    T = np.asarray(t_wc_true)
    if use is not None:
        C, T = C[use], T[use]
    worst = float("nan")
    for i in range(0, len(C), seg):
        if len(C[i:i + seg]) >= 3:
            e = ref_traj.horn_ate(C[i:i + seg], T[i:i + seg])
            worst = e if math.isnan(worst) else max(worst, e)
    return worst


def frame_at(scene, ts) -> np.ndarray:
    return np.rint(np.asarray(ts) / (scene.ts[1] - scene.ts[0])).astype(np.int64)


def inertial(scene, kf: dict, t0: float) -> dict:
    """kf_vel_err, kf_bg_err, kf_ba_err and gravity_deg of the keyframes
    made from time t0 on, each keyframe's velocity and vertical taken in its
    own camera frame (R_cw v, R_cw e_z), which no choice of the world frame
    changes; NaN when the map holds no keyframe from t0."""
    new = kf["ts"] >= t0 - 1e-6
    out = dict.fromkeys(("kf_vel_err", "kf_bg_err", "kf_ba_err", "gravity_deg"), math.nan)
    if not new.any():
        return out
    i = frame_at(scene, kf["ts"][new])
    R = kf["R"][new]
    R_true = np.transpose(scene.R_wc[i], (0, 2, 1))
    worst = lambda d: float(np.linalg.norm(d, axis=-1).max())  # noqa: E731
    out["kf_vel_err"] = worst((R @ kf["vel"][new][..., None] - R_true @ scene.v_w[i][..., None])
                              [..., 0])
    out["kf_bg_err"] = worst(kf["bg"][new] - scene.bias[i, 3:])
    out["kf_ba_err"] = worst(kf["ba"][new] - scene.bias[i, :3])
    # the angle between the map's vertical and the true one, seen from the camera
    a, b = R[:, :, 2], R_true[:, :, 2]
    ang = np.arctan2(np.linalg.norm(np.cross(a, b), axis=1), np.einsum("ni,ni->n", a, b))
    out["gravity_deg"] = float(np.degrees(ang).max())
    return out


def _recorded(scene, recorder, device):
    """(images, record) of each drawn frame the window built; None when a
    drawn frame or K2 call is missing (a window that tracked fewer frames
    than drawn, or a path that skipped the frame build or K2)."""
    if (len(recorder.k2) < len(recorder.k2_calls)
            or any("atlas" not in r or "uv" not in r for r in recorder.built.values())
            or set(recorder.built) != recorder.frames):
        return None
    return [(torch.as_tensor(scene.imgs[j], device=device), rec)
            for j, rec in sorted(recorder.built.items())]


MISSING = {"atlas_err": math.inf, "k1_bad": math.inf, "feat_bad": math.inf, "k2_bad": math.inf}


def trajectory(scene, window, R, t, ok, kf: dict, seg: dict) -> dict:
    """ate_m, kf_ate_m and the inertial numbers of window poses (R_cw, t_cw,
    tracked) and keyframes."""
    out = {"ate_m": segment_ate(R, t, scene.t_wc[window], seg["frames"], ok),
           "kf_ate_m": segment_ate(kf["R"], kf["t"], scene.t_wc[frame_at(scene, kf["ts"])],
                                   seg["keyframes"])}
    return {**out, **inertial(scene, kf, scene.ts[window[0]] if len(window) else math.inf)}


def numbers(scene, window, poses, kf, recorder, orb: dict, seg: dict, device) -> dict:
    """Every number of the run: `window` the scene frames whose poses the
    window returned, `poses` those (R_cw, t_cw, tracked), `kf` keyframes().
    A drawn frame or K2 call that the window did not make reads infinite."""
    recs = _recorded(scene, recorder, device)
    out = dict(MISSING)
    if recs is not None:
        out = {"atlas_err": 0.0, "k1_bad": 0, "feat_bad": 0}
        for imgs, rec in recs:
            shape = tuple(imgs.shape[1:])
            out["atlas_err"] = max(out["atlas_err"], atlas_err(imgs, rec["atlas"], orb))
            out["k1_bad"] += k1_bad(rec["atlas"], rec["scores"])
            out["feat_bad"] += feat_bad(rec["atlas"], rec, shape, orb)
        out["k2_bad"] = k2_bad(recorder.k2)
    ok = np.array([p[2] for p in poses], bool)
    R = np.array([p[0] for p in poses]).reshape(-1, 3, 3)
    t = np.array([p[1] for p in poses]).reshape(-1, 3)
    return {**out, **trajectory(scene, window, R, t, ok, kf, seg)}


def truth(scene, frames, kf: dict) -> tuple:
    """The truth in the program's place: (R_cw, t_cw) of `frames` and the
    keyframes (at their times) with the true velocities and biases."""
    def cw(i):
        R_cw = np.transpose(scene.R_wc[i], (0, 2, 1))
        return R_cw, -(R_cw @ scene.t_wc[i][..., None])[..., 0]

    i = frame_at(scene, kf["ts"])
    R, t = cw(i)
    return cw(frames), {"ts": kf["ts"], "R": R, "t": t, "vel": scene.v_w[i],
                        "bg": scene.bias[i, 3:], "ba": scene.bias[i, :3]}


def _frozen(poses, kf, new):
    """The state left as it was at the window's start: every window pose the
    first one, every keyframe made in the window the first such."""
    (R, t), kf = poses, dict(kf)
    R, t = np.broadcast_to(R[:1], R.shape), np.broadcast_to(t[:1], t.shape)
    if new.any():
        j = np.flatnonzero(new)
        for k in ("R", "t", "vel", "bg", "ba"):
            kf[k] = kf[k].copy()
            kf[k][j] = kf[k][j[0]]
    return (R, t), kf


def _altered(poses, kf, new):
    """Every other window pose and window keyframe moved FAULT_SHIFT_M along
    its camera's x axis (t_cw of a camera moved by d along its own x axis
    is t_cw - d e_x)."""
    def shift(t, mask):
        t = t.copy()
        t[mask, 0] -= FAULT_SHIFT_M
        return t

    (R, t), kf = poses, dict(kf)
    kf["t"] = shift(kf["t"], new & (np.cumsum(new) % 2 == 1))
    return (R, shift(t, np.arange(len(t)) % 2 == 0)), kf


FAULTS = {"frozen": _frozen, "pose_altered": _altered}


def fault_numbers(scene, window, kf, seg: dict) -> dict:
    """{fault: trajectory and inertial numbers} of each of FAULTS planted in
    the truth put in the program's place."""
    poses, tkf = truth(scene, window, kf)
    new = kf["ts"] >= scene.ts[window[0]] - 1e-6
    ok = np.ones(len(window), bool)
    out = {}
    for name, plant in FAULTS.items():
        (R, t), fkf = plant(poses, tkf, new)
        out[name] = trajectory(scene, window, R, t, ok, fkf, seg)
    return out


def control_numbers(scene, window, kf, recorder, orb: dict, seg: dict, device) -> dict:
    """The numbers of the control: each stage's reference in the program's
    place, on the stage's own recorded inputs, at the next lower precision
    (4-bit images and descriptor bytes, bfloat16 poses), held against the
    same comparisons."""
    out = {"atlas_err": 0.0, "k1_bad": 0, "feat_bad": 0}
    for imgs, rec in _recorded(scene, recorder, device) or ():
        shape = tuple(imgs.shape[1:])
        A = rec["atlas"]
        low = ref_frame.atlas(_quant4(imgs), orb["nLevels"], orb["scaleFactor"], 35)
        out["atlas_err"] = max(out["atlas_err"], atlas_err(imgs, low, orb))
        out["k1_bad"] += k1_bad(A, ref_frame.fast_score(_quant4(A)))
        uv, octave, ang, bits, valid = reference_features(
            A, ref_frame.fast_score(A), shape, orb, patch_atlas=_quant4(A))
        feat = {"uv": uv, "octave": octave, "angle": ang, "bits": bits, "valid": valid}
        out["feat_bad"] += feat_bad(A, feat, shape, orb)
    nib = torch.tensor(0xF0F0F0F0 - 2**32, dtype=torch.int32, device=device)
    out["k2_bad"] = k2_bad([(dq, dt, mask, cols, ref_hamming.best2(dq & nib, dt & nib, mask, cols))
                            for dq, dt, mask, cols, _ in recorder.k2])

    def bf16(x):
        return torch.as_tensor(x, dtype=torch.float32).to(torch.bfloat16).double().numpy()

    (R, t), tkf = truth(scene, window, kf)
    low = {k: v if k == "ts" else bf16(v) for k, v in tkf.items()}
    return {**out, **trajectory(scene, window, bf16(R), bf16(t), np.ones(len(window), bool),
                                low, seg)}
