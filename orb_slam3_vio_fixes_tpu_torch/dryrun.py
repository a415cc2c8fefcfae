"""Dry run of the multi-device layer (the port's twin of the JAX package's
`__graft_entry__.dryrun_multichip` and `_dryrun_realistic`).

`dryrun_multichip(n)` builds a `parallel.Mesh` of n shards and runs, on the
same numpy-seeded maps as the reference:
  * a tiny global BA (4 keyframes x 16 features, 8 n landmarks) through
    parallel/sharded_ba.distributed_global_ba;
  * a realistic map (64 keyframes x 128 features, 2048 landmarks, a full
    IMU chain) through the sharded visual GBA, the sharded full-map VI BA
    (optim/vi_global_ba.run_global_vi_ba_sharded), the 4-DoF essential
    graph of an inertial loop correction, and the sharded whole-map search
    (parallel/sharded_matching.sharded_global_bind), whose binds are held
    against the single-device matcher (`match_descriptors`).
It prints the reference's two lines and returns their numbers.

    python -m orb_slam3_vio_fixes_tpu_torch.dryrun [N_SHARDS] [--cpu]

Every shard sits on the card unless --cpu (or device="cpu") is given.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from orb_slam3_vio_fixes_tpu_torch.imu import preintegration as pre
from orb_slam3_vio_fixes_tpu_torch.ops import matching
from orb_slam3_vio_fixes_tpu_torch.optim import ba_core
from orb_slam3_vio_fixes_tpu_torch.optim import pose_graph as pg
from orb_slam3_vio_fixes_tpu_torch.optim import vi_ba, vi_global_ba
from orb_slam3_vio_fixes_tpu_torch.parallel import Mesh, sharded_ba
from orb_slam3_vio_fixes_tpu_torch.parallel import sharded_matching as sm
from orb_slam3_vio_fixes_tpu_torch.slam_map import map_state as ms
from orb_slam3_vio_fixes_tpu_torch.utils.cameras import Camera


def _state(cfg: ms.MapConfig, device, **fields) -> ms.MapState:
    return ms.empty(cfg, device)._replace(**{
        k: torch.as_tensor(v, device=device) for k, v in fields.items()})


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """The tiny sharded GBA, then `dryrun_realistic`, on n_devices shards
    of `device`. Returns the numbers of both."""
    mesh = Mesh([device] * n_devices, ("lm",))
    dev = mesh.devices[0]
    cam = Camera.pinhole(200.0, 200.0, 64.0, 48.0)
    bf = 20.0
    rng = np.random.default_rng(0)
    K, N = 4, 16
    L = 8 * n_devices
    cfg = ms.MapConfig(max_keyframes=K, max_landmarks=L, max_features=N)
    pts = rng.uniform(-2, 2, size=(L, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(4, 8, L)
    kf_R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    kf_t = np.zeros((K, 3), np.float32)
    kf_t[:, 0] = np.arange(K) * 0.1
    kf_obs = np.zeros((K, N), np.int32)
    kf_uv = np.zeros((K, N, 2), np.float32)
    kf_ur = np.full((K, N), -1.0, np.float32)
    for k in range(K):
        for i in range(N):
            lm = (k * 3 + i) % L
            kf_obs[k, i] = lm
            xc = kf_R[k] @ pts[lm] + kf_t[k]
            kf_uv[k, i] = [200 * xc[0] / xc[2] + 64, 200 * xc[1] / xc[2] + 48]
            kf_ur[k, i] = kf_uv[k, i, 0] - 20.0 / xc[2]
    state = _state(
        cfg, dev, kf_R=kf_R,
        kf_t=kf_t + rng.normal(0, 0.01, (K, 3)).astype(np.float32),
        kf_valid=np.ones(K, bool), kf_obs=kf_obs, kf_uv=kf_uv, kf_ur=kf_ur,
        kf_feat_valid=np.ones((K, N), bool),
        lm_pos=pts + rng.normal(0, 0.01, (L, 3)).astype(np.float32),
        lm_valid=np.ones(L, bool))
    inv_s2 = torch.ones(cfg.n_levels, device=dev)
    _, n_inl = sharded_ba.distributed_global_ba(
        state, inv_s2, cam, bf, mesh,
        cfg=ba_core.LMConfig(n_rounds=1, n_iters=2, solver="cg", cg_iters=8))
    out = {"inlier_factors": int(n_inl), "factors": K * N}
    print(f"dryrun_multichip({n_devices}): ok, inlier_factors={out['inlier_factors']}/{K * N}")
    out.update(dryrun_realistic(n_devices, mesh))
    return out


def realistic_map(device):
    """The reference's realistic map: 64 keyframes x 128 features of a
    forward flight at constant velocity over 2048 landmarks (gravity -Z,
    body == camera), each landmark a random descriptor seen with 1-2 flipped
    bits; and the exact IMU chain between the keyframes. Returns (state,
    inertial, calib, cam, bf)."""
    rng = np.random.default_rng(1)
    K, N, L = 64, 128, 2048
    dt = 0.25
    cam = Camera.pinhole(400.0, 400.0, 320.0, 240.0)
    bf = 40.0
    calib = pre.ImuCalib.make(1.7e-4, 2e-3, 1.9e-5, 3e-3, 200.0, device=device)
    cfg = ms.MapConfig(max_keyframes=K, max_landmarks=L, max_features=N)
    vel = np.array([0.4, 0.0, 0.1], np.float32)
    kf_p = np.arange(K, dtype=np.float32)[:, None] * (vel * dt)[None]
    kf_R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    pts = np.stack([rng.uniform(-6, 6, L), rng.uniform(-4, 4, L),
                    rng.uniform(6, 18, L)], 1).astype(np.float32)
    kf_obs = np.full((K, N), -1, np.int32)
    kf_uv = np.zeros((K, N, 2), np.float32)
    kf_ur = np.full((K, N), -1.0, np.float32)
    fv = np.zeros((K, N), bool)
    for k in range(K):
        xc = pts - kf_p[k]
        ok = xc[:, 2] > 1.0
        uv = np.stack([400 * xc[:, 0] / xc[:, 2] + 320,
                       400 * xc[:, 1] / xc[:, 2] + 240], 1)
        ok &= (uv[:, 0] > 0) & (uv[:, 0] < 640) & (uv[:, 1] > 0) & (uv[:, 1] < 480)
        idx = np.nonzero(ok)[0]
        rng.shuffle(idx)
        idx = idx[:N]
        n = len(idx)
        kf_obs[k, :n] = idx
        kf_uv[k, :n] = uv[idx] + rng.normal(0, 0.3, (n, 2))
        kf_ur[k, :n] = uv[idx, 0] - 40.0 / xc[idx, 2]
        fv[k, :n] = True
    lm_desc = rng.integers(0, 2**32, (L, 8), dtype=np.uint32)
    kf_desc = lm_desc[np.clip(kf_obs, 0, L - 1)]
    flip = np.uint32(1) << rng.integers(0, 32, kf_desc.shape).astype(np.uint32)
    kf_desc = np.where(rng.random(kf_desc.shape) < 0.3, kf_desc ^ flip, kf_desc)
    state = _state(
        cfg, device, kf_desc=kf_desc.view(np.int32), lm_desc=lm_desc.view(np.int32),
        kf_R=kf_R,
        kf_t=(-np.einsum("kij,kj->ki", kf_R, kf_p)
              + rng.normal(0, 0.02, (K, 3)).astype(np.float32)).astype(np.float32),
        kf_vel=np.tile(vel, (K, 1)), kf_ts=np.arange(K, dtype=np.float32) * dt,
        kf_prev=np.arange(K, dtype=np.int32) - 1, kf_valid=np.ones(K, bool),
        kf_obs=kf_obs, kf_uv=kf_uv, kf_ur=kf_ur, kf_feat_valid=fv,
        lm_pos=pts + rng.normal(0, 0.02, (L, 3)).astype(np.float32),
        lm_valid=np.ones(L, bool))
    # exact IMU between keyframes: gravity-only specific force
    S = int(dt * 200)
    win = np.zeros((K - 1, S, 7), np.float32)
    win[:, :, 2] = 9.81
    win[:, :, 6] = 1.0 / 200.0
    z = torch.zeros(3, device=device)
    pres = pre.integrate(torch.as_tensor(win, device=device), z, z, calib)
    inertial = vi_ba.VIInertialFactors.from_preintegrations(
        np.arange(K - 1), np.arange(1, K), pres, np.ones(K - 1, bool))
    return state, inertial, calib, cam, bf


def dryrun_realistic(n_devices: int, mesh: Mesh) -> dict:
    """The realistic map through (a) the sharded visual GBA, (b) the sharded
    full-map VI BA, (c) the 4-DoF essential graph with one loop edge and (d)
    the sharded whole-map search of keyframe 3's descriptors, bind for bind
    against the single-device matcher."""
    dev = mesh.devices[0]
    state, inertial, calib, cam, bf = realistic_map(dev)
    K, L = state.kf_R.shape[0], state.lm_pos.shape[0]
    inv_s2 = torch.ones(8, device=dev)
    _, n_inl_v = sharded_ba.distributed_global_ba(
        state, inv_s2, cam, bf, mesh,
        cfg=ba_core.LMConfig(n_rounds=1, n_iters=2, solver="cg", cg_iters=8))
    pose_fixed = torch.zeros(K, dtype=torch.bool, device=dev)
    pose_fixed[0] = True
    out_vi, n_inl_vi = vi_global_ba.run_global_vi_ba_sharded(
        state, inertial, inv_s2, cam, bf, calib, pose_fixed, mesh,
        cfg=vi_global_ba.VIGBAConfig(n_rounds=1, n_iters=2, cg_iters=8))
    # (c) the inertial loop correction's 4-DoF essential graph
    edges = pg.essential_edges_from_map(
        out_vi.kf_R.cpu().numpy(), out_vi.kf_t.cpu().numpy(),
        out_vi.kf_valid.cpu().numpy(), out_vi.kf_prev.cpu().numpy(),
        ms.covisibility(out_vi).cpu().numpy(), 256, cov_threshold=100, device=dev)
    n_e = int(edges.valid.sum())
    pg.add_loop_edge(edges, n_e, 0, K - 1, out_vi.kf_R[K - 1] @ out_vi.kf_R[0].T,
                     out_vi.kf_t[K - 1], 1.0, weight=100.0)
    # the pad edges weigh 0 and add exact zeros
    edges = pg.PoseGraphEdges(*(f[:n_e + 1] for f in edges))
    fixed = torch.zeros(K, dtype=torch.bool, device=dev)
    fixed[0] = True
    _, _, _, chi2 = pg.optimize_pose_graph(
        out_vi.kf_R, out_vi.kf_t, torch.ones(K, device=dev), fixed, edges,
        pg.PoseGraphConfig(n_iters=4, fix_scale=True, four_dof=True))
    # (d) the sharded whole-map search against the single-device matcher
    fd, fv3 = out_vi.kf_desc[3], out_vi.kf_feat_valid[3]
    lm_ids = sm.sharded_global_bind(fd, fv3, out_vi.lm_desc, out_vi.lm_valid, mesh,
                                    axis=mesh.axis_names[0]).cpu().numpy()
    ref = matching.match_descriptors(fd, fv3, out_vi.lm_desc, out_vi.lm_valid, ratio=0.75,
                                     max_dist=matching.TH_LOW, mutual=False).idx.cpu().numpy()
    both = (lm_ids >= 0) & (ref >= 0)
    out = {"K": K, "L": L, "visual_inliers": int(n_inl_v), "vi_inliers": int(n_inl_vi),
           "pose_graph_chi2": float(chi2.reshape(-1)[-1]),
           "sharded_match_bound": int((lm_ids >= 0).sum()),
           "parity": int((lm_ids[both] == ref[both]).sum()), "both": int(both.sum()),
           "bound_only_one": int(((lm_ids >= 0) != (ref >= 0)).sum())}
    print(f"dryrun_multichip({n_devices}) realistic: ok, K={K} L={L} "
          f"visual_inliers={out['visual_inliers']} vi_inliers={out['vi_inliers']} "
          f"pose_graph_chi2={out['pose_graph_chi2']:.3f} "
          f"sharded_match_bound={out['sharded_match_bound']} "
          f"parity={out['parity']}/{out['both']}")
    return out


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cpu" if "--cpu" in argv else "cuda"
    argv = [a for a in argv if a != "--cpu"]
    n = int(argv[0]) if argv else 4
    if device == "cuda":
        from orb_slam3_vio_fixes_tpu_torch.utils import determinism

        determinism.enable()
    dryrun_multichip(n, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
