"""System facade: the top-level SLAM entry point (port of
orb_slam3_vio_fixes_tpu/system.py).

`SLAMSystem` wires a tracker, a loop closer, a relocaliser and an Atlas
around one MapState for every sensor mode: MONOCULAR, STEREO, RGBD,
IMU_MONOCULAR, IMU_STEREO and IMU_RGBD. Distorted pin-hole rigs are
rectified (stereo) or undistorted (monocular, RGB-D) per frame on the
device. A KannalaBrandt8 stereo rig is tracked unrectified: both camera
models and T_c1_c2 go to the tracker, whose frames are built by ray
triangulation. The multi-device `mesh` waits for a later slice and raises
NotImplementedError.

The facade runs on the card unless the caller passes `device="cpu"`; it
raises when CUDA is absent rather than falling back. It switches PyTorch to
deterministic algorithms (`utils/determinism.py`): one input, one answer.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from orb_slam3_vio_fixes_tpu_torch.frontend import loop_closing as lc_mod
from orb_slam3_vio_fixes_tpu_torch.frontend import relocalization as rl_mod
from orb_slam3_vio_fixes_tpu_torch.frontend import tracking as trk
from orb_slam3_vio_fixes_tpu_torch.frontend.inertial_tracking import (
    InertialConfig, MonoInertialTracker, StereoInertialTracker)
from orb_slam3_vio_fixes_tpu_torch.frontend.mono_tracking import MonoInit, MonocularTracker
from orb_slam3_vio_fixes_tpu_torch.imu import preintegration as pre
from orb_slam3_vio_fixes_tpu_torch.io import trajectory as traj_io
from orb_slam3_vio_fixes_tpu_torch.io.settings import Settings, load_settings
from orb_slam3_vio_fixes_tpu_torch.ops import orb
from orb_slam3_vio_fixes_tpu_torch.ops import rectify as rec
from orb_slam3_vio_fixes_tpu_torch.sensors import Sensor
from orb_slam3_vio_fixes_tpu_torch.slam_map import atlas as atlas_mod
from orb_slam3_vio_fixes_tpu_torch.slam_map import map_state as ms
from orb_slam3_vio_fixes_tpu_torch.slam_map import snapshot
from orb_slam3_vio_fixes_tpu_torch.slam_map import vocabulary as voc
from orb_slam3_vio_fixes_tpu_torch.utils import determinism

__all__ = ["SLAMSystem", "Sensor"]


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("SLAMSystem runs on a CUDA device and none is available; "
                           "pass device='cpu' to run on the CPU")
    return dev


class SLAMSystem:
    """Tracker + loop closing + relocalisation + Atlas for one sensor setup.

    settings: a parsed `Settings` or the path of a v1.0 YAML file;
    vocab: a `Vocabulary`, "default" (the checked-in 10^5-word artifact) or
    None (no place recognition); map_cfg / tracker_cfg override the
    configuration derived from the settings; device: "cuda" (the default)
    or "cpu".
    """

    def __init__(self, settings, sensor: Sensor, vocab="default",
                 map_cfg: Optional[ms.MapConfig] = None,
                 tracker_cfg: Optional[trk.TrackerConfig] = None, mesh=None,
                 device="cuda"):
        determinism.enable()
        if mesh is not None:
            raise NotImplementedError("the multi-device mesh is not ported yet")
        self.device = _device(device)
        if isinstance(settings, str):
            settings = load_settings(settings, sensor)
        self.settings: Settings = settings
        self.sensor = sensor
        if isinstance(vocab, str):
            if vocab != "default":
                raise ValueError(f"unknown vocabulary spec {vocab!r}")
            vocab = voc.default_vocabulary(self.device)
        self.vocab = vocab

        # distorted rigs: remaps, and cam1 / bf rewritten before the trackers
        # capture the calibration
        settings.precompute_rectification()
        settings.precompute_undistortion()
        self._rect_maps = self._undist_map = None
        if settings.rect is not None:
            self._rect_maps = torch.as_tensor(
                np.stack([settings.rect.map1, settings.rect.map2]), device=self.device)
        elif settings.undist_map is not None:
            self._undist_map = torch.as_tensor(settings.undist_map, device=self.device)

        s = settings
        dev = self.device
        if map_cfg is None:
            map_cfg = ms.MapConfig(n_levels=s.n_levels, scale=s.scale_factor,
                                   max_features=s.n_features)
        cfg = tracker_cfg or trk.TrackerConfig(
            orb=orb.ORBConfig(n_features=s.n_features, n_levels=s.n_levels,
                              scale=s.scale_factor),
            map=map_cfg, width=s.new_width or s.width, height=s.new_height or s.height,
            th_depth_factor=s.th_depth, max_frames_between_kf=int(s.fps))
        self.cfg = cfg
        inv_s2 = trk.octave_inv_sigma2(cfg.orb, dev)

        # a two-camera KannalaBrandt8 rig: both camera models and T_c1_c2;
        # bf = baseline * fx for the depth thresholds when the settings give
        # none
        rig = None
        if (sensor.is_stereo and s.camera_type == "KannalaBrandt8"
                and s.cam2 is not None and s.T_c1_c2 is not None):
            T = np.asarray(s.T_c1_c2, np.float32)
            rig = (s.cam2, T[:3, :3], T[:3, 3])
            if not s.bf:
                s.bf = float(np.linalg.norm(T[:3, 3])) * float(s.cam1.fx)

        closer = reloc = atl = None
        if vocab is not None:
            # the scale is fixed for every sensor but pure monocular (stereo,
            # RGB-D and inertial maps are metric); inertial maps use the
            # 4-DoF graph with the scale gate and yaw clamp, the tracker's
            # full-map VI BA as their global BA, and merges aligned in yaw
            # and translation only
            closer = lc_mod.LoopCloser(
                vocab, s.cam1, map_cfg.max_keyframes, inv_s2,
                lc_mod.LoopConfig(fix_scale=sensor != Sensor.MONOCULAR,
                                  inertial=sensor.has_imu, run_gba=not sensor.has_imu),
                bf=(s.bf or 0.0) if not sensor.is_monocular else 0.0,
                n_levels=cfg.orb.n_levels, scale=cfg.orb.scale, device=dev)
            reloc = rl_mod.Relocalizer(vocab, lambda: closer.db, device=dev)
            atl = atlas_mod.Atlas(map_cfg, vocab, s.cam1, inv_s2,
                                  atlas_mod.AtlasConfig(fix_scale=not sensor.is_monocular,
                                                        inertial=sensor.has_imu), device=dev)
        self.loop_closer = closer
        self.relocalizer = reloc
        self.atlas = atl

        if sensor.has_imu:
            T_bc = s.T_bc if s.T_bc is not None else np.eye(4, dtype=np.float32)
            calib = pre.ImuCalib.make(s.noise_gyro, s.noise_acc, s.walk_gyro, s.walk_acc,
                                      s.imu_freq, R_bc=T_bc[:3, :3], t_bc=T_bc[:3, 3],
                                      device=dev)
            if sensor.is_monocular:
                self.tracker = MonoInertialTracker(
                    s.cam1, calib, cfg, device=dev, loop_closer=closer,
                    relocalizer=reloc, atlas=atl)
            else:
                self.tracker = StereoInertialTracker(
                    s.cam1, s.bf, calib, cfg, InertialConfig(), device=dev,
                    loop_closer=closer, relocalizer=reloc, atlas=atl, rig=rig)
        elif sensor.is_monocular:
            self.tracker = MonocularTracker(s.cam1, cfg, device=dev, loop_closer=closer,
                                            relocalizer=reloc, atlas=atl)
        else:
            self.tracker = trk.StereoTracker(s.cam1, s.bf, cfg, device=dev,
                                             loop_closer=closer, relocalizer=reloc,
                                             atlas=atl, rig=rig)
        if sensor.is_rgbd:
            # RGB-D searches a wider local window
            self.tracker.th_local_base = 1.5
        if s.load_file:
            self.load_atlas(s.load_file)

    # -- per-frame entries --

    def _rectify_pair(self, img_l, img_r):
        """Both eyes through the rectification remap on the device."""
        if self._rect_maps is None:
            return img_l, img_r
        return (rec.remap_bilinear(self._to_f32(img_l), self._rect_maps[0]),
                rec.remap_bilinear(self._to_f32(img_r), self._rect_maps[1]))

    def _to_f32(self, img) -> torch.Tensor:
        if isinstance(img, torch.Tensor):
            return img.to(self.device, torch.float32)
        return self.tracker._upload(np.asarray(img, np.float32))

    @staticmethod
    def _no_imu(imu):
        return imu if imu is not None else np.zeros((0, 7), np.float32)

    def track_stereo(self, img_l, img_r, ts: float, imu=None):
        img_l, img_r = self._rectify_pair(img_l, img_r)
        if self.sensor == Sensor.IMU_STEREO:
            return self.tracker.process_stereo_inertial(img_l, img_r, ts, self._no_imu(imu))
        if self.sensor != Sensor.STEREO:
            raise ValueError(f"track_stereo called in {self.sensor} mode")
        return self.tracker.process_stereo(img_l, img_r, ts)

    def track_rgbd(self, img, depth, ts: float, imu=None):
        if not self.sensor.is_rgbd:
            raise ValueError(f"track_rgbd called in {self.sensor} mode")
        # a distorted camera is undistorted in both modes (the reference skips
        # the remap with an IMU)
        if self._undist_map is not None:
            img = rec.remap_bilinear(self._to_f32(img), self._undist_map)
            depth = rec.remap_nearest(self._to_f32(depth), self._undist_map)
        if self.sensor == Sensor.IMU_RGBD:
            return self.tracker.process_rgbd_inertial(img, depth, ts, self._no_imu(imu))
        return self.tracker.process_rgbd(img, depth, ts)

    def track_monocular(self, img, ts: float, imu=None):
        if not self.sensor.is_monocular:
            raise ValueError(f"track_monocular called in {self.sensor} mode")
        if self._undist_map is not None:
            img = rec.remap_bilinear(self._to_f32(img), self._undist_map)
        if self.sensor == Sensor.IMU_MONOCULAR:
            return self.tracker.process_mono_inertial(img, ts, self._no_imu(imu))
        return self.tracker.process_mono(img, ts)

    # -- mode switches / lifecycle --

    def activate_localization_mode(self):
        """Track against the existing map without growing it (the pending
        keyframe jobs land first)."""
        self.tracker.flush()
        self.tracker.localization_only = True

    def deactivate_localization_mode(self):
        self.tracker.localization_only = False

    def reset(self):
        """Full reset: the stored maps go too."""
        if self.atlas is not None:
            self.atlas.stored = []
        self.reset_active_map()

    def reset_active_map(self):
        tr = self.tracker
        tr._kf_jobs.clear()         # pending stages name dying slots
        tr._freeze_trajectory()     # keyframe slots are going away
        # the map tier is the tracker's: growth updates tracker.cfg (and the
        # database) but not the facade's
        tr.state = ms.empty(tr.cfg.map, self.device)
        tr.n_kf = 0
        tr.n_lm = 0
        tr.kf_order = []
        tr._free_kf_slots = []
        tr.track_state = trk.TrackState.NOT_INITIALIZED
        tr.vel = None
        tr.prev_obs = tr.prev_octave = tr.prev_angle = None
        tr.frames_since_kf = 0
        tr.lost_frames = 0
        tr._window_key = None
        if isinstance(tr, StereoInertialTracker):
            tr._reset_inertial_state()
        if isinstance(tr, MonoInit):
            tr.ref_frame = None
        if self.loop_closer is not None:
            self.loop_closer.reset()

    def shutdown(self):
        """No threads to join in this design; kept for the reference's API."""

    # -- state queries --

    def get_tracking_state(self) -> str:
        return self.tracker.track_state

    def is_lost(self) -> bool:
        return self.tracker.track_state in (trk.TrackState.RECENTLY_LOST,
                                            trk.TrackState.LOST)

    def get_velocity(self):
        body = getattr(self.tracker, "body", None)
        return None if body is None else body.v.cpu().numpy()

    def n_keyframes(self) -> int:
        return self.tracker.n_kf

    def n_landmarks(self) -> int:
        return self.tracker.n_lm

    # -- trajectory export --

    def save_trajectory_tum(self, path: str):
        traj_io.save_tum(path, self.tracker.trajectory)

    def save_trajectory_euroc(self, path: str):
        traj_io.save_euroc(path, self.tracker.trajectory)

    def save_trajectory_kitti(self, path: str):
        traj_io.save_kitti(path, self.tracker.trajectory)

    def save_keyframe_trajectory_tum(self, path: str):
        traj_io.save_tum(path, self.tracker.keyframe_trajectory())

    def save_keyframe_trajectory_euroc(self, path: str):
        traj_io.save_euroc(path, self.tracker.keyframe_trajectory())

    # -- Atlas snapshots --

    def save_atlas(self, path: str):
        """The whole Atlas: active map, stored maps, BoW databases, counters
        and the vocabulary's checksum."""
        tr = self.tracker
        tr.flush()                  # the map is saved whole
        hists = self.loop_closer.db.hist if self.loop_closer is not None else None
        stored = self.atlas.stored if self.atlas is not None else ()
        snapshot.save_atlas(path, tr.state, tr.cfg.map, tr.n_kf, tr.n_lm, tr.kf_order,
                            stored=stored, hists=hists, vocab=self.vocab)

    def load_atlas(self, path: str):
        """Restore a whole Atlas; tracking resumes LOST and relocalises into
        the loaded map."""
        state, cfg, meta, hists, stored, _ = snapshot.load_atlas(path, vocab=self.vocab,
                                                                 device=self.device)
        tr = self.tracker
        tr._freeze_trajectory()     # old entries must not resolve via new slots
        tr.state = state
        # every holder of the map tier follows the loaded capacity
        if cfg != tr.cfg.map:
            tr.cfg = tr.cfg._replace(map=cfg)
            self.cfg = self.cfg._replace(map=cfg)
            if self.loop_closer is not None:
                self.loop_closer.grow(cfg.max_keyframes)
            if self.atlas is not None:
                self.atlas.map_cfg = cfg
        tr.n_kf = meta["n_kf"]
        tr.n_lm = meta["n_lm"]
        tr.kf_order = list(meta["kf_order"])
        tr._free_kf_slots = []
        tr._window_key = None
        tr.track_state = trk.TrackState.LOST
        tr.lost_frames = 0
        tr.vel = None
        if isinstance(tr, StereoInertialTracker):
            # the snapshot holds no IMU windows, and the previous map's name
            # its keyframe slots: the loaded map re-initialises its IMU after
            # the relocalisation (the reference keeps them)
            tr._reset_inertial_state()
        if self.atlas is not None:
            self.atlas.stored = [atlas_mod.StoredMap(*sm) for sm in stored]
        if self.loop_closer is not None:
            if hists is not None:
                self.loop_closer.db = voc.KeyFrameDatabase(
                    torch.as_tensor(hists, device=self.device))
            else:
                # no stored histograms: rebuild the database from the map
                self.loop_closer.db = voc.KeyFrameDatabase.empty(
                    cfg.max_keyframes, self.loop_closer.vocab.n_words, self.device)
                self.loop_closer._pending_group = None
                self.loop_closer._pending_count = 0
                for k in tr.kf_order:
                    self.loop_closer.add_keyframe(state, k)
