"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero). Phases 1-5 run
in this process; phases 7-20 run meanwhile in five worker processes on the
same card, grouped as WORKERS says, each group in its order; phase 6 runs
last, once every worker has ended:
  1. card facts (nvidia-smi name and power limit); no CUDA -> exit non-zero;
  2. build the hand-written kernels from orb_slam3_vio_fixes_tpu_torch/csrc;
  3. K1 (FAST score) against its plain PyTorch twin, exact, on random and
     half-integer atlases at the main path's shape, at W = 751 and at
     H = 7, W = 37, and on rendered frames' atlases;
  4. K2 (fused masked Hamming best-2 + column argmin, one launch) against its
     plain twin, exact, with and without columns: 1024x1024 and 2048x1024
     with random, dense, sparse, tie-heavy, nearly and wholly masked inputs;
     Q = T = 1, T = 1000 and 2048, Q = 300; the two masks captured from
     the main path (frame 0's stereo row match, a local-map search); and the
     whole-map search's shapes, Q = 1024 against T = 8192 (one shard's block
     of a 32768-row landmark table on phase 20's 4-shard mesh) and T = 32768,
     with a real map's valid-row mask and a tie-heavy one;
  5. the main path: the bench scenario (80 frames of 752x480 stereo, 1024
     features, 8 levels) through the port's StereoTracker in sync mode, with
     the kernel launch counters reset before and read after; the final state
     must be OK, >= 3 keyframes, K1 launched once per frame, K2 at least
     once per matcher call that the tracker's control flow always makes (and
     once with columns per stereo and triangulation call), and the ATE
     within the stated bound of the JAX package's;
  6. timing: fps and p50/p95 frame ms of the counted pass of phase 5 (the
     separate timing pass is cut) and each kernel at the path's shapes:
     device time per call back to back
     (CUDA events) and the host's time to enqueue it, the kernel's own
     execution time (torch.profiler), bound, plain twin's time and the first
     slice's recorded time;
  7. the stereo-inertial path: bench.py's stereo-inertial scenario (60 frames
     of 752x480 stereo with 200 Hz IMU, 1024 features) through the port's
     StereoInertialTracker, the launch counters reset before and read after;
     the final state must be OK with the IMU initialised, >= 2 window VI
     BAs, the ATE within the stated bound of the JAX package's, the final
     speed within 25% of the true one, K1 launched once per frame and K2 at
     least once per matcher call the control flow always makes; K1 and K2
     are held against their plain twins once more on this path's inputs;
     that pass also prints synchronised host-clock stage times and, from
     torch.profiler over its last 3 frames, launches per frame and the
     device's idle share (its separate timing pass is cut; phase 14's
     IMU_STEREO run times the same scene through the facade);
  8. loop closing: tests/test_e2e_loop.py's revisit (88 frames of 752x480
     around a 72-frame lap, 2 gray levels of noise) through the StereoTracker
     with a keyframe at least every 4 frames, first without and then with a
     LoopCloser on the 10^5-word vocabulary (launches counted, loop stages
     timed per keyframe, each correction timed): at
     least one correction, the best hit 2x over every gate, the ATE below the
     run without the closer and within the stated bound of the JAX
     package's, the revisit gap below 0.8x; K1 and K2 exact on this path's
     inputs (K2 on masks captured inside verify_candidate);
  9. relocalisation: tests/test_relocalization.py's blackout at 752x480 (12
     frames, 4 blank, a jump to frame 6's pose): OK again, one success,
     camera centre within 5 cm; K2 exact on a reloc_attempt mask;
 10. Atlas: tests/test_atlas.py's scenario at 752x480: the map is stashed
     after 3 lost frames, a new one starts and merges into it on the revisit
     (centre within 10 cm); K2 exact on a verify_cross_candidate mask;
 11. snapshots: the Atlas saved and loaded back after the stash and after
     the merge, every array equal.
 12. the stereo-inertial loop: tests/test_e2e_inertial_loop.py's revisit at
     752x480 (88 frames, 72-frame lap, 200 Hz IMU, 2 gray levels of noise)
     through the StereoInertialTracker without and then with an inertial
     LoopCloser on the 10^5-word vocabulary (the JAX package closes the
     loop with it at this width): at least one correction, body-frame
     gravity within GRAVITY_MEDIAN_DEG (median) and 8 degrees (max),
     keyframe velocities consistent with the corrected poses, the ATE below
     the run without the closer and within the stated bound of the JAX
     package's; loop stage
     times per keyframe and the post-loop full VI BA time; K1 and K2 exact
     on this path's inputs (K2 on verify_candidate masks); then the input of
     the first post-loop full VI BA solved again by run_global_vi_ba_sharded
     on a 4-shard mesh of the card, within the JAX test's sharded-parity bars
     of the unsharded result (keyframe positions 2e-3 m, rotation traces
     3 - 1e-4, landmark median 1e-3 m, inliers 2%);
 13. stereo-inertial relocalisation and Atlas (SI_ATLAS_PLAN on a 52-frame
     lap, recently_lost_time cut to 0.25 s): after the IMU initialisation a
     short blackout ends in a relocalisation inside the dead-reckoning
     window (centre within 5 cm), a long one sends the map to the Atlas, the
     new map initialises its IMU and merges through the VI merge BA (centre
     within 10 cm; an inertial merge keeps only the Sim3's yaw and
     translation once the map's IMU has had 5 s of data, and map B merges
     0.55 s after its initialisation, so here the full Sim3 applies);
     snapshots after the stash and the merge; K2 exact on reloc_attempt and
     verify_cross_candidate masks;
 14. the facade: SLAMSystem(device="cuda") for STEREO, RGBD, IMU_STEREO and
     IMU_RGBD from a YAML file written here, 30-40 frames each through
     track_stereo / track_rgbd: state OK, the IMU initialised where there is
     one, ATE within the stated bound of the JAX package's SLAMSystem on the
     same frames, K1 once per frame (B = 1 for RGB-D, exact against its
     plain twin on those atlases), K2 at least once per matcher call
     (RGB-D: no stereo row match), save_atlas -> load_atlas equal; then
     configs/EuRoC.yaml through the port's parser and rectification, the
     remap of a rendered pair on the card within 1e-3 of the CPU's;
 15. the app: the host runtime library built from native/orbslam3_tpu_rt.cpp
     into build/native (a queue round trip, its Hamming matchers exactly
     against their numpy twins), then the drone-VIO app through its entry
     point, apps.main_template("euroc", "IMU_STEREO") with --vio-config
     {"mode": "odometry"} (no port: the MAVLink loopback) and the 10^5-word
     vocabulary, on phase 14's 36 IMU_STEREO frames written as a EuRoC
     directory (image files served from memory: the card's machine has no
     PIL; the 200 Hz mav0/imu0/data.csv): PipelineRunner on the native
     queue -> SLAMSystem -> MAVLinkInterface. Checks: 36 frames, state OK,
     the IMU initialised, a TUM file of 36 lines of 8 fields whose ATE is
     within phase 14's IMU_STEREO bound, the native queue used, one CRC-valid
     ODOMETRY per frame that had a pose, the last equal to the tracker's
     final pose in NED within 1e-5, K1 once per frame and K2 at least once
     per matcher call; K1 exact on two of its atlases, K2 on a local-map
     search mask of its post-init frames. Prints the runner's stage times
     and fps beside phase 14's direct IMU_STEREO loop, and the MAVLink
     layer's ms per frame.
 16. the monocular path: phase 5's 80 frames (left images) through the
     port's MonocularTracker: state OK, >= 3 keyframes, the scale-aligned
     ATE within the stated bound of the JAX package's, K1 once per frame on
     a one-image (B = 1) atlas, K2 at least once per matcher call (the
     two-view search, then two per tracked frame and six per keyframe
     insert); K1 and K2 exact on this path's inputs, K2 on a
     search_for_initialization mask;
 17. the monocular-inertial path: tests/test_e2e_mono_inertial.py's scene
     at 752x480 (60 frames, 200 Hz IMU) through MonoInertialTracker: the IMU
     initialised with a free scale, the metric ATE from the IMU chain's
     first keyframe on within the stated bound of the JAX package's, the
     Horn scale within 0.12 of 1, the same kernel checks as phase 16.
 18. pipelining: phase 5's 80 frames through bench.py's tracker driven as
     bench.py drives it (frame i + 1 uploads while frame i tracks, flush()
     at the end) three times: sync, `pipelined` (each frame's tracking step
     dispatched before the previous frame's decisions, keyed on the map's
     write versions; the wide-radius retry selected on the device) and
     `pipelined` with `async_kf` (local BA, culling, loop closing as one job
     per later frame). Gates: pipelined equals sync bit for bit (the
     trajectory, keyframe order, landmark count), async within
     tests/test_pipelined.py's bars against sync, every pass's ATE within
     phase 5's bound, K1 once per frame, K2 exact on the pipelined path's
     densest motion-model mask. Prints per pass fps and frame p50 / p95
     (frames 1-59, host clock), stream syncs per frame (frames 60-69), the
     device's idle share (frames 70-79) and the speculation hit rate;
 19. the KannalaBrandt8 rig: configs/TUM-VI.yaml's two cameras, T_c1_c2,
     T_b_c1 and IMU at 512x512 along bench.py's stereo-inertial trajectory
     (a room-scale world), through SLAMSystem in IMU_STEREO and STEREO (40
     frames each, tracked unrectified): frame 0's two-camera build (>= 60
     depths, median relative error < 0.15 against the z-buffer), per mode
     state OK and the ATE within the stated bound of the JAX package's
     SLAMSystem on the same frames, K1 once per frame (B = 2, 512x512) and
     K2 at least once per matcher call; K1 exact on frame 0's atlas, K2 on
     its brute-force left-right mask.
 20. the multi-device mesh on the one card (parallel.Mesh of 4 shards, all
     on it): (a) phase 8's loop scene with a LoopCloser on the mesh: a
     correction, every correction's global BA landmark-sharded, the ATE
     within phase 8's bound; the first correction's GBA input solved by the
     unsharded run_global_ba (camera centres within 2e-3 m, landmark median
     within 1e-3 m) and by the sharded solve twice more, byte for byte the
     run's; (b) phase 9's blackout through a Relocalizer on the mesh (axis
     "db"): the hit from the whole-map search (n_success_global), the centre
     within 5 cm, one K2 launch per shard per search; (c)
     dryrun.dryrun_multichip(4) with full bind parity, and the dense
     distributed BA step twice on one input, byte-identical. Prints ms per
     sharded and unsharded GBA and per sharded search, launches and peak
     device memory.
Phase 14 also runs MONOCULAR (40 frames) and IMU_MONOCULAR (60) through
track_monocular. Each of phases 8-17 and 20 prints its K1/K2 launches and peak
device memory; phases 18-19 print their launches per pass and mode. The whole
script runs in PyTorch's deterministic mode
(utils/determinism.py, switched on before any CUDA work): one answer per
input, so a gate passes or fails the same way on every run of one build.

The last lines are one JSON object with the kernels, the card's name and
power limit, and {"ok": true, "device": {...}}.
"""

import contextlib
import json
import os
import re
import struct
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

# ATE of the JAX package's StereoTracker (sync mode: pipelined=False,
# async_kf=False) on the same 80-frame bench scenario, measured once on a CPU
# with JAX 0.9.0 by running bench.make_sequence() / bench.build_tracker()
# through process_stereo and evaluation.ate.ate_rmse on the camera centres.
JAX_ATE_M = 0.003896803325557025
ATE_FACTOR = 1.5
ATE_SLACK_M = 0.005

N_FRAMES = 80

# ATE of the JAX package's StereoInertialTracker on the same 60-frame
# stereo-inertial scenario (bench.run_inertial_bench's sequence, tracker and
# configuration, one pass), measured once on a CPU with JAX 0.9.0 through
# process_stereo_inertial and evaluation.ate.ate_rmse on the camera centres.
# That run ended OK, IMU initialised at frame 15, 8 window VI BAs, final
# speed error 0.0266 m/s.
JAX_VI_ATE_M = 0.008476832977569036
VI_FRAMES = 60
VI_SPEED_TOL = 0.25         # |v_est - v_gt| < 0.25 max(v_gt, 0.2) (test bar)
# Frames of phase 7 under torch.profiler: each frame's ~35k kernel records
# take seconds of the host to read.
VI_PROFILED_FRAMES = 3

# ATE of the JAX package's StereoTracker with a LoopCloser on the loop
# scenario of make_loop_sequence (the same generator calls, seed and noise),
# tracker_config with max_frames_between_kf=4, LoopConfig(min_gap_kfs=8,
# n_consistency=2, fix_scale=True) and the checked-in 10^5-word vocabulary
# (orb_slam3_vio_fixes_tpu/assets/vocab_b10d5.npz), sync mode, measured once
# on a CPU with JAX 0.9.0 through process_stereo and evaluation.ate.ate_rmse
# on the camera centres. That run made 2 corrections (best hit: 401 matches,
# 283 Sim3 inliers, 309 projections) and a revisit gap of 0.2653 m; without
# the closer its ATE was 0.17617 m and the gap 0.5398 m.
JAX_LOOP_ATE_M = 0.027254149578157468
LOOP_FRAMES = 88
LOOP_LAP = 72

# Phase 20: the multi-device mesh on one card, every shard on it. The
# sharded global BA against the unsharded one on the first correction's
# input: camera centres within 2e-3 m and the landmark median within 1e-3 m
# (tests/test_vi_global_ba.py::test_vi_gba_sharded_parity_8_devices's bars).
MESH_SHARDS = 4
MESH_CENTRE_M = 2e-3
MESH_LM_MEDIAN_M = 1e-3

# The stereo-inertial revisit (tests/test_e2e_inertial_loop.py's scenario at
# 752x480 with the bench's camera) and its configuration. ATE of the JAX
# package's StereoInertialTracker with an inertial LoopCloser on the 10^5-word
# vocabulary, and without it, on the same frames: measured once on a CPU with
# JAX 0.9.0 by tests/test_torch_inertial_loop.py::
# test_jax_inertial_loop_reference_at_full_width. That run made 2
# corrections (hits at keyframes 37-39 and 46-47).
SI_LOOP_FRAMES = 88
SI_LOOP_LAP = 72
SI_LOOP_ICFG = dict(frame_samples=16, kf_samples=128, init_min_kfs=4, init_min_time=0.5,
                    vi_window=6, max_local_lm=1024, fix_scale=True)
SI_LOOP_LCFG = dict(min_gap_kfs=8, n_consistency=2, fix_scale=True, inertial=True,
                    run_gba=False)
SI_LOOP_RADIUS = (15.0, 30.0)
JAX_SI_LOOP_ATE_M = 0.20478798986326235
JAX_SI_LOOP_OFF_ATE_M = 0.27649443279886854
# tests/test_e2e_inertial_loop.py's bars on the corrected map: body-frame
# gravity within 3 degrees (median) and 8 (max) over the keyframes, keyframe
# velocities within 0.35 (median relative error). The tilt is set at the IMU
# initialisation (0.5 s of IMU under a ~1 g centripetal acceleration) and
# moves with small perturbations of the frames. The JAX package reads a
# median of 2.908 degrees (max 3.230) on these frames, and 2.484, 1.603 and
# 1.269 on three other noise draws of the scene (SI_LOOP_NOISE_SEEDS; by
# tests/test_torch_inertial_loop.py on a CPU). The port on an H100 read
# 2.04-3.17 on these frames over four runs and 3.19, 2.11 and 2.52 on the
# other draws (orb_slam3_vio_fixes_tpu_torch/gravity_spread.py): 0.57
# degrees above the JAX package on average over the four draws, inside the
# spread of either (1.1 degrees between the port's runs on one draw, 1.6
# between the reference's draws). The 3-degree bar sits 0.09 degrees above
# the reference's own reading on these frames, so the median bar here is
# 1.5x the JAX package's on the same frames, as for the ATE, and never
# below 3.
JAX_SI_LOOP_GRAVITY_DEG = (2.9080807193571108, 3.2303455889398127)
# Other image-noise draws on the same scene (make_si_loop_sequence's
# noise_seed), and the JAX package's (median, max) gravity error on each.
SI_LOOP_NOISE_SEEDS = (1, 2, 3)
JAX_SI_LOOP_GRAVITY_SPREAD_DEG = {1: (2.4837489501746295, 3.204240794547045),
                                  2: (1.603154404323862, 3.6324866482942038),
                                  3: (1.2692581157629061, 2.820985926337509)}
GRAVITY_MEDIAN_DEG = max(3.0, ATE_FACTOR * JAX_SI_LOOP_GRAVITY_DEG[0])
GRAVITY_MAX_DEG, VELOCITY_REL_ERR = 8.0, 0.35

# The stereo-inertial relocalisation and Atlas scenario: a 52-frame lap of
# the same scene (7 degrees a frame), the track lost after the IMU
# initialisation. Cut: recently_lost_time 0.25 s (5 frames) instead of 5 s,
# so that the Atlas run's blackout (8 frames) ends the dead reckoning.
SI_ATLAS_LAP = 52
SI_ATLAS_LOST_TIME = 0.25
# Relocalisation: map A's frames, blank frames, then the view of frame
# `reloc_view`. Atlas: map A's frames, blank frames that end it; map B runs
# to `frames`.
SI_ATLAS_PLAN = dict(reloc_map=17, reloc_blank=2, reloc_view=12, atlas_map=23, lost_blank=8,
                     frames=65)

# The monocular phases. Phase 16: the bench scene's left images (phase 5's
# 80 frames) through MonocularTracker with the bench's tracker configuration.
# Phase 17: tests/test_e2e_mono_inertial.py's scene generator (seed 11,
# accel_amp 0.8, 700 sprites) at 752x480 with fx 458 and 1024 features, 60
# frames, through MonoInertialTracker with that test's InertialConfig (IMU
# init after 8 keyframes and 1.2 s, free scale) and a keyframe at least
# every 6 frames, as there. The JAX numbers are the JAX package's trackers
# on the same frames, measured once on a CPU with JAX 0.9.0 by
# tests/test_torch_mono.py::test_jax_mono_reference_at_full_width and
# tests/test_torch_mono_inertial.py::
# test_jax_mono_inertial_reference_at_full_width: phase 16's scale-aligned
# ATE (monocular maps have no scale), phase 17's metric ATE over the frames
# from the IMU chain's first keyframe on (no scale alignment: the IMU must
# have made the map metric), as in the JAX tests. Those runs ended OK: phase
# 16 with 20 keyframes (Horn scale 9.80: the map's unit is the first pair's
# median depth), phase 17 with the IMU initialised, 24 keyframes, Horn scale
# 0.896 over 55 frames (scale-aligned ATE 0.0223 m). The facade's monocular
# modes (scored alike): tests/test_torch_system.py::
# test_jax_facade_reference_at_full_width.
JAX_MONO_ATE_M = 0.021289207021509757
MI_FRAMES = 60
MI_ICFG = dict(frame_samples=16, kf_samples=256, init_min_kfs=8, init_min_time=1.2,
               vi_window=6, max_local_lm=1024, fix_scale=False)
JAX_MI_ATE_M = 0.11974048796600748
MI_SCALE_TOL = 0.12         # |Horn scale - 1| (tests/test_e2e_mono_inertial.py)
JAX_FACADE_MONO_ATE_M = 0.02601094404694476
JAX_FACADE_MONO_INERTIAL_ATE_M = 0.052541329847834495

# The facade: SLAMSystem from a YAML file written at run time (a rectified
# 752x480 pin-hole pair with the bench's camera; the IMU noise block of
# configs/EuRoC.yaml with the body frame on the left camera, as the
# synthetic IMU is), frames per mode, and the JAX package's SLAMSystem ATE on
# the same frames, measured once on a CPU with JAX 0.9.0 by
# tests/test_torch_system.py::test_jax_facade_reference_at_full_width.
FACADE_YAML = """%YAML:1.0
---
File.version: "1.0"
Camera.type: "Rectified"
Camera1.fx: 458.0
Camera1.fy: 458.0
Camera1.cx: 376.0
Camera1.cy: 240.0
Camera.width: 752
Camera.height: 480
Camera.fps: 20
Camera.RGB: 1
Camera.bf: 50.38
Stereo.ThDepth: 35.0
IMU.T_b_c1:
  rows: 4
  cols: 4
  data: [1.0, 0.0, 0.0, 0.0,
         0.0, 1.0, 0.0, 0.0,
         0.0, 0.0, 1.0, 0.0,
         0.0, 0.0, 0.0, 1.0]
IMU.NoiseGyro: 1.7e-04
IMU.NoiseAcc: 2.0e-03
IMU.GyroWalk: 1.9393e-05
IMU.AccWalk: 3.0e-03
IMU.Frequency: 200.0
ORBextractor.nFeatures: 1024
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""
FACADE_FRAMES = {"STEREO": 40, "RGBD": 30, "IMU_STEREO": 36, "IMU_RGBD": 36,
                 "MONOCULAR": 40, "IMU_MONOCULAR": 60}
JAX_FACADE_ATE_M = {"STEREO": 0.005074487028276547, "RGBD": 0.004336191602072658,
                    "IMU_STEREO": 0.006273376860191582, "IMU_RGBD": 0.00600935824044728,
                    "MONOCULAR": JAX_FACADE_MONO_ATE_M,
                    "IMU_MONOCULAR": JAX_FACADE_MONO_INERTIAL_ATE_M}

# Phase 18: bench.py's tracker (phase 5's scenario) in sync mode, pipelined,
# and pipelined with asynchronous keyframe jobs; the async pass against the
# sync one within tests/test_pipelined.py's bars (landmark count within 10%,
# camera centres within 0.01 m median and 0.05 m max).
PIPELINE_MODES = (("sync", False, False), ("pipelined", True, False),
                  ("async", True, True))
ASYNC_LM_FRAC = 0.10
ASYNC_MEDIAN_M = 0.01
ASYNC_MAX_M = 0.05

# Phase 19: a KannalaBrandt8 rig with configs/TUM-VI.yaml's calibration (both
# cameras, T_c1_c2, T_b_c1, the IMU's rate and noise) at 512x512 along
# bench.py's stereo-inertial trajectory (seed 11), through SLAMSystem; the
# JAX package's SLAMSystem ATE on the same frames, measured once on a CPU
# with JAX 0.9.0 by
# tests/test_torch_fisheye.py::test_jax_fisheye_reference_at_full_width.
FISHEYE_CONFIG = os.path.join("configs", "TUM-VI.yaml")
FISHEYE_FRAMES = 40
FISHEYE_MODES = ("IMU_STEREO", "STEREO")
JAX_FISHEYE_ATE_M = {"IMU_STEREO": 0.041926531943301794, "STEREO": 0.05063428316676271}
FISHEYE_POINTS = 800
FISHEYE_MIN_DEPTHS = 60            # tests/test_fisheye_stereo.py's frame bars
FISHEYE_DEPTH_REL = 0.15

# Phase 15 writes the facade's IMU_STEREO frames as a EuRoC directory whose
# stamps start here (nanoseconds).
APP_T0_NS = 10**9

# The card's peaks for the bounds: HBM3 rate of the H100 SXM, and its INT32
# rate, a quarter of the 67 TFLOP/s float32 rate (an FMA counts 2 flops, and
# an SM has 64 INT32 lanes beside 128 FP32 lanes).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
# K1 per interior pixel: 46 packed min/max (22 + 16 min3, 8 max3 over the 16
# arcs and the centre) + 1 subtraction of the centre; K2 per admissible pair:
# 8 XOR + 8 POPC + 7 ADD.
K1_OPS_PER_PX = 47
K2_OPS_PER_PAIR = 23

# Device ms of the first slice's kernels (PERF.md, NVIDIA H100 80GB HBM3 at
# 700 W), at the shapes timed below.
PR1_MS = {"fast_score 2x2380x752": 0.0553,
          "hamming_match 1024x1024 cols": 0.0249 + 0.0452,
          "hamming_match 1024x1024 rows": 0.0249,
          "hamming_match 2048x1024 rows": 0.0254,
          "hamming_match 2048x1024 cols": 0.0254 + 0.0874}


def log(msg: str) -> None:
    print(msg, flush=True)


def sync() -> None:
    torch.cuda.synchronize()


def card_facts() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, iters: int, host: bool = False):
    """Mean device milliseconds per call over `iters` back-to-back calls.
    The stream is held busy (torch.cuda._sleep) while the host enqueues
    them, so the events time the device and not the host's launch rate.
    With `host`, also the host's milliseconds per call to enqueue them."""
    fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(iters * 4e5))      # ~0.2 ms of cycles per call
    start.record()
    h0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = 1e3 * (time.perf_counter() - h0) / iters
    end.record()
    sync()
    dev_ms = start.elapsed_time(end) / iters
    return (dev_ms, host_ms) if host else dev_ms


def profiled_ms(fn, iters: int = 20) -> dict:
    """Device ms per call of each kernel (and memset) that `fn` launches, from
    torch.profiler's kernel records: execution alone, without the gaps
    between launches that the events of cuda_ms include."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        sync()
    return {re.sub(r"^.*?_cu_[0-9a-f]{8}\d+", "", e.key)[:40]:
            e.device_time_total / 1e3 / iters
            for e in prof.key_averages() if getattr(e, "device_time_total", 0) > 0}


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """Least ms the card could take: bytes over HBM, int ops over INT32."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, n_ops / INT32_OPS_PER_S
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def k1_bound(x) -> tuple[float, str]:
    b, h, w = x.shape
    interior = b * max(h - 6, 0) * max(w - 6, 0)
    return bound(8.0 * b * h * w, K1_OPS_PER_PX * interior)


def k2_bound(dq, dt, mask, cols) -> tuple[float, str]:
    Q, T = mask.shape
    n_bytes = Q * T + 32 * (Q + T) + 16 * Q + (8 * T if cols else 0)
    return bound(n_bytes, K2_OPS_PER_PAIR * int(mask.sum()))


def make_sequence(n_frames: int = N_FRAMES):
    """bench.make_sequence() with the port's numpy generator."""
    from orb_slam3_vio_fixes_tpu_torch.io import synthetic

    rng = np.random.default_rng(7)
    world = synthetic.make_world(rng, n_points=1400, extent=10.0,
                                 depth_range=(3.0, 14.0))
    seq = synthetic.make_stereo_sequence(rng, n_frames=n_frames, h=480, w=752,
                                         fx=458.0, baseline=0.11, world=world)
    return seq._replace(
        imgs_l=np.clip(np.rint(seq.imgs_l), 0, 255).astype(np.uint8),
        imgs_r=np.clip(np.rint(seq.imgs_r), 0, 255).astype(np.uint8))


def tracker_config(seq, max_frames_between_kf: int = 20):
    """bench.build_tracker()'s configuration for the port."""
    from orb_slam3_vio_fixes_tpu_torch.frontend import tracking
    from orb_slam3_vio_fixes_tpu_torch.ops import orb
    from orb_slam3_vio_fixes_tpu_torch.slam_map import map_state as ms

    return tracking.TrackerConfig(
        orb=orb.ORBConfig(n_features=1024, n_levels=8),
        map=ms.MapConfig(max_keyframes=256, max_landmarks=32768,
                         max_features=1024),
        width=seq.imgs_l.shape[2], height=seq.imgs_l.shape[1],
        max_frames_between_kf=max_frames_between_kf)


def camera_of(seq):
    from orb_slam3_vio_fixes_tpu_torch.utils.cameras import Camera

    return Camera.pinhole(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2])


def build_tracker(seq, device, **kw):
    """bench.build_tracker() for the port, sync mode; `kw` passes a loop
    closer, relocaliser or Atlas."""
    from orb_slam3_vio_fixes_tpu_torch.frontend import tracking

    return tracking.StereoTracker(camera_of(seq), seq.K[0, 0] * seq.baseline,
                                  tracker_config(seq), device=device, **kw)


def atlases_of(seq, i, device):
    from orb_slam3_vio_fixes_tpu_torch.ops import image as image_ops

    layout = image_ops.atlas_layout(480, 752, 8, 1.2, align=35)
    imgs = torch.from_numpy(np.stack([seq.imgs_l[i], seq.imgs_r[i]])).to(device)
    return image_ops.build_pyramid_atlas(imgs, 8, 1.2, layout)


def check_k1(seq, device) -> dict:
    from orb_slam3_vio_fixes_tpu_torch.ops import fast

    g = torch.Generator(device=device).manual_seed(0)

    def ints(shape, half=False):
        x = torch.randint(0, 511 if half else 256, shape, generator=g, device=device)
        return x.to(torch.float32) * (0.5 if half else 1.0)

    cases = {
        "random": ints((2, 2380, 752)),
        # half-integers exercise the round-half-to-even step
        "random_half": ints((2, 2380, 752), half=True),
        # W % 4 != 0 takes the scalar staging path; H, W below one tile
        "w751": ints((2, 2380, 751)),
        "w751_half": ints((2, 2380, 751), half=True),
        "h7_w37": ints((2, 7, 37)),
        "h7_w37_half": ints((2, 7, 37), half=True),
        "frame0": atlases_of(seq, 0, device),
        "frame_last": atlases_of(seq, seq.imgs_l.shape[0] - 1, device),
    }
    err = 0.0
    for name, x in cases.items():
        got = fast.fast_score_batch(x)
        ref = fast.fast_score_plain(x)
        sync()
        e = float((got - ref).abs().max())
        n_bad = int((got != ref).sum())
        log(f"[k1] {name}: shape={tuple(x.shape)} max_abs_err={e} mismatches={n_bad} "
            f"nonzero={int((ref > 0).sum())}")
        if n_bad:
            raise RuntimeError(f"K1 disagrees with its plain twin on {name}")
        err = max(err, e)
    return {"max_abs_err": err}


def _k2_inputs(g, Q, T, kind, device):
    def rnd(n):
        return torch.randint(-2**31, 2**31, (n, 8), generator=g, device=device,
                             dtype=torch.int64).to(torch.int32)

    if kind == "ties":
        # descriptors from a tiny pool, one differing word: distances repeat
        pool = rnd(4)
        dq = pool[torch.randint(0, 4, (Q,), generator=g, device=device)].clone()
        dt = pool[torch.randint(0, 4, (T,), generator=g, device=device)].clone()
        dq[:, 0] = torch.randint(0, 4, (Q,), generator=g, device=device).to(torch.int32)
        dt[:, 0] = torch.randint(0, 4, (T,), generator=g, device=device).to(torch.int32)
    else:
        dq, dt = rnd(Q), rnd(T)
    density = {"dense": 1.0, "random": 0.3, "sparse": 0.002, "ties": 0.5,
               "empty_rows": 0.0005, "none": 0.0}[kind]
    mask = torch.rand((Q, T), generator=g, device=device) < density
    return dq, dt, mask


def _k2_compare(label, dq, dt, mask) -> int:
    """Fused kernel vs plain twin, with and without columns; max abs error."""
    from orb_slam3_vio_fixes_tpu_torch.ops import matching

    names = ("best_idx", "best", "second", "second_idx", "col_idx")
    err = 0
    for cols in (False, True):
        got = matching.hamming_match(dq, dt, mask, cols)
        ref = matching.match_plain(dq, dt, mask, cols)
        sync()
        if not cols and got[4] is not None:
            raise RuntimeError("K2 returned columns it was not asked for")
        pairs = [(n, a, b) for n, a, b in zip(names, got, ref) if b is not None]
        bad = [n for n, a, b in pairs if not torch.equal(a, b)]
        ties = int((ref[1] == ref[2]).sum())
        log(f"[k2] {label} cols={cols}: mismatching={bad} rows_with_tie={ties}")
        if bad:
            raise RuntimeError(f"K2 disagrees with its plain twin on {label}: {bad}")
        err = max(err, max(int((a - b).abs().max()) for _, a, b in pairs))
    return err


def check_k2(device, path_masks) -> dict:
    g = torch.Generator(device=device).manual_seed(1)
    err = 0
    shapes = [((Q, 1024), kind) for Q in (1024, 2048)
              for kind in ("random", "dense", "sparse", "ties", "empty_rows", "none")]
    shapes += [((1, 1), "dense"), ((1024, 1000), "random"), ((1024, 2048), "random"),
               ((1024, 2048), "ties"), ((300, 1024), "random"), ((300, 1000), "ties")]
    for (Q, T), kind in shapes:
        err = max(err, _k2_compare(f"{Q}x{T} {kind}", *_k2_inputs(g, Q, T, kind, device)))
    for name, (dq, dt, mask, _) in path_masks.items():
        if name != "whole_map":
            err = max(err, _k2_compare(f"path {name} {tuple(mask.shape)}", dq, dt, mask))
    # the whole-map search's shapes (phase 20): Q = 1024 features against one
    # shard's block of a 32768-row landmark table on a 4-shard mesh and
    # against the whole table, masks from a real map's valid rows and
    # tie-heavy ones
    fd, fv, lm_desc, lm_valid = path_masks["whole_map"]
    for T in (8192, 32768):
        mask = fv[:, None] & lm_valid[None, :T]
        log(f"[k2] whole-map {fd.shape[0]}x{T} map: valid_queries={int(fv.sum())} "
            f"valid_rows={int(lm_valid[:T].sum())} admissible={int(mask.sum())}")
        err = max(err, _k2_compare(f"whole-map {fd.shape[0]}x{T} map", fd,
                                   lm_desc[:T].contiguous(), mask))
        err = max(err, _k2_compare(f"whole-map 1024x{T} ties",
                                   *_k2_inputs(g, 1024, T, "ties", device)))
    return {"max_abs_err": float(err)}


def matcher_recorder(wanted, densest: bool = False):
    """(record, tagged, out): `record` stands in for matching.hamming_match
    and keeps the inputs of the first call made under each wanted caller
    path in `out` (with `densest`, of the call with the most admissible
    pairs, which reads each wanted call's mask count on the host);
    `tagged(key, fn)` wraps fn so that the calls it makes are under key
    ("outer/inner" when nested)."""
    from orb_slam3_vio_fixes_tpu_torch.ops import matching

    out, tags, sizes = {}, [], {}
    match = matching.hamming_match

    def record(desc_q, desc_t, mask, cols):
        key = "/".join(tags)
        if key in wanted:
            n = int(mask.sum()) if densest else 0
            if key not in out or n > sizes[key]:
                out[key] = (desc_q.clone(), desc_t.clone(), mask.clone(), cols)
                sizes[key] = n
        return match(desc_q, desc_t, mask, cols)

    def tagged(key, fn):
        def call(*args, **kw):
            tags.append(key)
            try:
                return fn(*args, **kw)
            finally:
                tags.pop()
        return call

    return record, tagged, out


def capture_path_masks(seq, device) -> dict:
    """Frame 0's stereo row-match mask and the first local-map search mask of
    a fresh tracker's first frames: the masks the main path gives K2."""
    from orb_slam3_vio_fixes_tpu_torch.frontend import tracking
    from orb_slam3_vio_fixes_tpu_torch.ops import matching

    record, tagged, out = matcher_recorder({"stereo_frame0", "local_map_search"})
    tr = build_tracker(seq, device)
    with mock.patch.object(matching, "hamming_match", record), \
            mock.patch.object(matching, "stereo_row_match",
                              tagged("stereo_frame0", matching.stereo_row_match)), \
            mock.patch.object(tracking, "local_map_search",
                              tagged("local_map_search", tracking.local_map_search)):
        for i in range(3):
            tr.process_stereo(seq.imgs_l[i], seq.imgs_r[i], seq.ts[i])
    sync()
    for key in ("stereo_frame0", "local_map_search"):
        if key not in out:
            raise RuntimeError(f"no {key} matcher call in the first frames")
        _, _, mask, cols = out[key]
        log(f"[k2] path mask {key}: shape={tuple(mask.shape)} cols={cols} "
            f"density={float(mask.float().mean())!r} admissible={int(mask.sum())}")
    # the whole-map search's inputs on this map: keyframe 0's features
    # against the landmark table (phase 20's relocaliser binds a frame so)
    st = tr.state
    out["whole_map"] = (st.kf_desc[0].clone(), st.kf_feat_valid[0].clone(),
                        st.lm_desc.clone(), st.lm_valid.clone())
    return out


def facade_scenario(mode: str, synthetic, n_frames=None):
    """(frames, ts, t_wc) of the facade phase for one sensor mode, from
    `synthetic` (the port's io/synthetic.py here; the JAX package's in the
    test that measures the JAX numbers): the bench's stereo or stereo-inertial
    scene, each frame (image or left image, right image or metric depth,
    timestamp, IMU samples since the previous frame or None). The monocular
    modes take the left images of the STEREO and IMU_STEREO scenes."""
    n = n_frames or FACADE_FRAMES[mode]
    if mode in ("MONOCULAR", "IMU_MONOCULAR"):
        frames, ts, t_wc = facade_scenario(mode[:-len("MONOCULAR")] + "STEREO", synthetic, n)
        return [(left, None, t, imu) for left, _, t, imu in frames], ts, t_wc
    if mode in ("STEREO", "RGBD"):
        rng = np.random.default_rng(7)
        world = synthetic.make_world(rng, n_points=1400, extent=10.0,
                                     depth_range=(3.0, 14.0))
        if mode == "STEREO":
            s = synthetic.make_stereo_sequence(rng, n_frames=n, h=480, w=752, fx=458.0,
                                               baseline=0.11, world=world)
            frames = [(quantize(s.imgs_l[i]), quantize(s.imgs_r[i]), s.ts[i], None)
                      for i in range(n)]
        else:
            s = synthetic.make_rgbd_sequence(rng, n_frames=n, h=480, w=752, fx=458.0,
                                             world=world)
            frames = [(quantize(s.imgs[i]), s.depths[i], s.ts[i], None) for i in range(n)]
        return frames, s.ts, s.t_wc
    rng = np.random.default_rng(11)
    world = synthetic.make_world(rng, n_points=1400, extent=10.0, depth_range=(3.0, 14.0))
    s = synthetic.make_stereo_inertial_sequence(rng, n_frames=n, h=480, w=752, fx=458.0,
                                                baseline=0.11, world=world, imu_hz=200.0,
                                                accel_amp=0.6)
    imus = [s.imu[i - 1] if i > 0 else np.zeros((0, 7), np.float32) for i in range(n)]
    if mode == "IMU_STEREO":
        frames = [(quantize(s.imgs_l[i]), quantize(s.imgs_r[i]), s.ts[i], imus[i])
                  for i in range(n)]
    else:
        frames = []
        for i in range(n):
            R_cw = s.R_wc[i].T
            img, depth = synthetic.render(world, s.K, R_cw, -R_cw @ s.t_wc[i], 480, 752,
                                          return_depth=True)
            frames.append((quantize(img), depth, s.ts[i], imus[i]))
    return frames, s.ts, s.t_wc


def track_facade(slam, frames, states=None):
    """Every frame through the facade's entry for its sensor; host seconds
    per frame (synchronised when the facade runs on the card), and each
    frame's tracking state appended to `states` when given."""
    per_frame = []
    for a, b, ts, imu in frames:
        f0 = time.perf_counter()
        if slam.sensor.is_rgbd:
            slam.track_rgbd(a, b, ts, imu)
        elif slam.sensor.is_monocular:
            slam.track_monocular(a, ts, imu)
        else:
            slam.track_stereo(a, b, ts, imu)
        if slam.device.type == "cuda":
            sync()
        per_frame.append(time.perf_counter() - f0)
        if states is not None:
            states.append(slam.get_tracking_state())
    return per_frame


def mono_scores(ts, t_wc, traj, t_from=-np.inf):
    """(metric ATE, scale-aligned ATE, Horn scale, frames scored) of the
    trajectory's frames from stamp `t_from` on, against the true centres."""
    from orb_slam3_vio_fixes_tpu_torch.evaluation import ate

    est = [x for x in traj if x[0] >= t_from]
    C = np.array([-R.T @ t for _, R, t in est])
    if not np.all(np.isfinite(C)):
        raise RuntimeError("bad trajectory: non-finite poses")
    est_ts = np.array([x[0] for x in est])
    metric, _, n = ate.ate_rmse(ts, t_wc, est_ts, C)
    aligned, scale, _ = ate.ate_rmse(ts, t_wc, est_ts, C, with_scale=True)
    return metric, aligned, scale, n


def facade_ate(mode: str, tr, ts, t_wc, n_frames) -> float:
    """The facade's ATE of one sensor mode: metric over every frame; the
    monocular map's after scale alignment; the monocular-inertial map's
    metric over the frames from its IMU chain's first keyframe on."""
    if mode == "MONOCULAR":
        _, rmse, _, n = mono_scores(ts, t_wc, tr.trajectory)
        if n != n_frames:
            raise RuntimeError(f"ATE over {n} of {n_frames} frames")
        return rmse
    if mode == "IMU_MONOCULAR":
        return mono_scores(ts, t_wc, tr.trajectory, tr.t_first_kf)[0]
    return trajectory_ate(ts, t_wc, tr, n_frames)


def make_inertial_sequence(n_frames: int = VI_FRAMES):
    """bench.run_inertial_bench's sequence with the port's numpy generator."""
    from orb_slam3_vio_fixes_tpu_torch.io import synthetic

    rng = np.random.default_rng(11)
    world = synthetic.make_world(rng, n_points=1400, extent=10.0,
                                 depth_range=(3.0, 14.0))
    seq = synthetic.make_stereo_inertial_sequence(
        rng, n_frames=n_frames, h=480, w=752, fx=458.0, baseline=0.11, world=world,
        imu_hz=200.0, accel_amp=0.6)
    return seq._replace(
        imgs_l=np.clip(np.rint(seq.imgs_l), 0, 255).astype(np.uint8),
        imgs_r=np.clip(np.rint(seq.imgs_r), 0, 255).astype(np.uint8))


def build_inertial_tracker(seq, device):
    """bench.run_inertial_bench's tracker for the port, sync mode."""
    from orb_slam3_vio_fixes_tpu_torch.frontend import inertial_tracking as it
    from orb_slam3_vio_fixes_tpu_torch.imu import preintegration as pre

    icfg = it.InertialConfig(frame_samples=16, kf_samples=256, init_min_kfs=4,
                             init_min_time=0.5, vi_window=6, fix_scale=True)
    calib = pre.ImuCalib.make(1.7e-4, 2e-3, 1.9e-5, 3e-3, seq.imu_hz, device=device)
    return it.StereoInertialTracker(camera_of(seq), seq.K[0, 0] * seq.baseline, calib,
                                    tracker_config(seq), icfg, device=device)


def track_frame(tr, seq, i):
    """One frame through the tracker's entry point (stereo or stereo-inertial,
    by the sequence)."""
    if hasattr(seq, "imu"):
        imu = seq.imu[i - 1] if i > 0 else np.zeros((0, 7), np.float32)
        return tr.process_stereo_inertial(seq.imgs_l[i], seq.imgs_r[i], seq.ts[i], imu)
    return tr.process_stereo(seq.imgs_l[i], seq.imgs_r[i], seq.ts[i])


def run_pass(seq, device, build=build_tracker):
    tr = build(seq, device)
    per_frame = []
    for i in range(seq.imgs_l.shape[0]):
        f0 = time.perf_counter()
        track_frame(tr, seq, i)
        sync()
        per_frame.append(time.perf_counter() - f0)
    return tr, per_frame


def run_inertial_pass(seq, device):
    return run_pass(seq, device, build=build_inertial_tracker)


def main_path(seq, device, card) -> dict:
    from orb_slam3_vio_fixes_tpu_torch import kernels
    from orb_slam3_vio_fixes_tpu_torch.evaluation import ate
    from orb_slam3_vio_fixes_tpu_torch.frontend.tracking import TrackState

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    tr, per_frame = run_pass(seq, device)
    sync()
    counts = kernels.launch_counts()
    wall = time.perf_counter() - t0
    log(f"[timing] {card}: {frame_stats(per_frame)} (the counted first pass; frame 0 "
        f"excluded)")
    # Matcher calls the control flow always makes: a stereo match per frame
    # (with columns), a motion-model and a local-map search per tracked
    # frame, and per inserted keyframe a triangulation (with columns) and a
    # fusion for each of 3 neighbour slots. Retries and the reference-KF
    # fallback add more.
    n_ins = tr._kf_seq
    min_calls = N_FRAMES + 2 * (N_FRAMES - 1) + 6 * n_ins
    min_cols = N_FRAMES + 3 * n_ins
    traj = tr.trajectory
    est_ts = np.array([x[0] for x in traj])
    est_pos = np.array([-x[1].T @ x[2] for x in traj])
    if not np.all(np.isfinite(est_pos)) or est_pos.shape != (N_FRAMES, 3):
        raise RuntimeError(f"bad trajectory: shape {est_pos.shape}")
    rmse, _, n = ate.ate_rmse(seq.ts, seq.t_wc, est_ts, est_pos)
    ate_bound = ATE_FACTOR * JAX_ATE_M + ATE_SLACK_M
    log(f"[main] frames={N_FRAMES} wall={wall:.1f}s state={tr.track_state} "
        f"keyframes={len(tr.kf_order)} n_kf={tr.n_kf} landmarks={tr.n_lm} "
        f"ate_rmse_m={rmse!r} bound_m={ate_bound!r} (jax {JAX_ATE_M!r}) "
        f"launches={counts} keyframe_inserts={n_ins} "
        f"min_matcher_calls={min_calls} min_matcher_calls_with_cols={min_cols}")
    if tr.track_state != TrackState.OK:
        raise RuntimeError(f"final track state {tr.track_state}")
    if len(tr.kf_order) < 3:
        raise RuntimeError(f"only {len(tr.kf_order)} keyframes")
    if n != N_FRAMES or not rmse <= ate_bound:
        raise RuntimeError(f"ATE {rmse} m over the bound {ate_bound} m (n={n})")
    if counts["fast_score"] != N_FRAMES:
        raise RuntimeError(f"K1 launched {counts['fast_score']} times for "
                           f"{N_FRAMES} frames")
    if (counts["hamming_match"] < min_calls
            or counts["hamming_match_cols"] < min_cols):
        raise RuntimeError(f"K2 launched {counts['hamming_match']} times "
                           f"({counts['hamming_match_cols']} with columns) for at "
                           f"least {min_calls} matcher calls ({min_cols} with columns)")
    return counts


def inertial_path(seq, device, card) -> dict:
    """The stereo-inertial path once, counted, with the matcher's inputs of
    the post-init motion-model and local-map searches recorded, synchronised
    host-clock stage times and torch.profiler over the last
    VI_PROFILED_FRAMES frames
    (launches per frame; `profile_track.py --inertial` gives them per
    stage); checks its outcome and holds K1 and K2 against their plain
    twins on this path's inputs. Returns the launch counts."""
    import functools

    from orb_slam3_vio_fixes_tpu_torch import kernels
    from orb_slam3_vio_fixes_tpu_torch import profile_track as pt
    from orb_slam3_vio_fixes_tpu_torch.evaluation import ate
    from orb_slam3_vio_fixes_tpu_torch.frontend import inertial_tracking as it
    from orb_slam3_vio_fixes_tpu_torch.frontend import tracking
    from orb_slam3_vio_fixes_tpu_torch.frontend.tracking import TrackState
    from orb_slam3_vio_fixes_tpu_torch.ops import fast, matching

    vi_keys = ("vi_track_step/match_previous", "vi_track_step/local_map_search")
    record, tagged, masks = matcher_recorder(set(vi_keys))
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with mock.patch.object(matching, "hamming_match", record), \
            mock.patch.object(it, "vi_track_step", tagged("vi_track_step", it.vi_track_step)), \
            mock.patch.object(tracking, "match_previous",
                              tagged("match_previous", tracking.match_previous)), \
            mock.patch.object(tracking, "local_map_search",
                              tagged("local_map_search", tracking.local_map_search)), \
            pt.stage_timers(pt.INERTIAL_STAGES) as times:
        tr = build_inertial_tracker(seq, device)
        step = functools.partial(track_frame, tr, seq)
        start = VI_FRAMES - VI_PROFILED_FRAMES
        for i in range(start):
            step(i)
        pt.device_profile(step, range(start, VI_FRAMES), top=8, by_stage=False,
                          prefix=f"[profile] {card}: stereo-inertial frames "
                          f"{start}-{VI_FRAMES - 1}, stages synchronised")
    sync()
    counts = kernels.launch_counts()
    wall = time.perf_counter() - t0
    pt.print_stages(times, prefix=f"[stages] {card}: stereo-inertial")
    n_ins = tr._kf_seq
    min_calls = VI_FRAMES + 2 * (VI_FRAMES - 1) + 6 * n_ins
    min_cols = VI_FRAMES + 3 * n_ins
    traj = tr.trajectory
    est_ts = np.array([x[0] for x in traj])
    est_pos = np.array([-x[1].T @ x[2] for x in traj])
    if not np.all(np.isfinite(est_pos)) or est_pos.shape != (VI_FRAMES, 3):
        raise RuntimeError(f"bad stereo-inertial trajectory: shape {est_pos.shape}")
    rmse, _, n = ate.ate_rmse(seq.ts, seq.t_wc, est_ts, est_pos)
    ate_bound = ATE_FACTOR * JAX_VI_ATE_M + ATE_SLACK_M
    v_est = float(np.linalg.norm(tr.velocity_log[-1])) if tr.velocity_log else float("nan")
    v_gt = float(np.linalg.norm(seq.vel_gt[-1]))
    v_tol = VI_SPEED_TOL * max(v_gt, 0.2)
    log(f"[inertial] frames={VI_FRAMES} wall={wall:.1f}s state={tr.track_state} "
        f"imu_ready={tr.imu_ready} n_vi_ba={tr.n_vi_ba} keyframes={len(tr.kf_order)} "
        f"keyframe_inserts={n_ins} landmarks={tr.n_lm} ate_rmse_m={rmse!r} "
        f"bound_m={ate_bound!r} (jax {JAX_VI_ATE_M!r}) speed_est={v_est!r} "
        f"speed_gt={v_gt!r} speed_tol={v_tol!r} launches={counts} "
        f"min_matcher_calls={min_calls} min_matcher_calls_with_cols={min_cols}")
    if tr.track_state != TrackState.OK:
        raise RuntimeError(f"stereo-inertial final track state {tr.track_state}")
    if not tr.imu_ready or tr.n_vi_ba < 2:
        raise RuntimeError(f"imu_ready={tr.imu_ready} n_vi_ba={tr.n_vi_ba}")
    if n != VI_FRAMES or not rmse <= ate_bound:
        raise RuntimeError(f"stereo-inertial ATE {rmse} m over the bound {ate_bound} m")
    if not abs(v_est - v_gt) < v_tol:
        raise RuntimeError(f"final speed {v_est} m/s vs {v_gt} m/s (tolerance {v_tol})")
    if counts["fast_score"] != VI_FRAMES:
        raise RuntimeError(f"K1 launched {counts['fast_score']} times for "
                           f"{VI_FRAMES} stereo-inertial frames")
    if (counts["hamming_match"] < min_calls
            or counts["hamming_match_cols"] < min_cols):
        raise RuntimeError(f"K2 launched {counts['hamming_match']} times "
                           f"({counts['hamming_match_cols']} with columns) for at "
                           f"least {min_calls} matcher calls ({min_cols} with columns)")
    for i in (0, VI_FRAMES - 1):
        x = atlases_of(seq, i, device)
        got, ref = fast.fast_score_batch(x), fast.fast_score_plain(x)
        sync()
        n_bad = int((got != ref).sum())
        log(f"[k1] stereo-inertial frame {i}: mismatches={n_bad}")
        if n_bad:
            raise RuntimeError(f"K1 disagrees with its plain twin on frame {i}")
    for key in vi_keys:
        if key not in masks:
            raise RuntimeError(f"no {key} matcher call on the stereo-inertial path")
        dq, dt, mask, _ = masks[key]
        log(f"[k2] stereo-inertial path mask {key}: shape={tuple(mask.shape)} "
            f"density={float(mask.float().mean())!r}")
        _k2_compare(f"stereo-inertial {key}", dq, dt, mask)
    return counts


def path_kernel_times(seq, device, path_masks, card) -> dict:
    """Each kernel at shapes the main path gives it: device ms, bound, plain
    twin's ms and the first slice's ms. Returns the JSON rows' numbers."""
    from orb_slam3_vio_fixes_tpu_torch.ops import fast, matching

    rows = {}
    x = atlases_of(seq, 0, device)
    rows["fast_score 2x2380x752"] = (
        *cuda_ms(lambda: fast.fast_score_batch(x), 50, host=True),
        cuda_ms(lambda: fast.fast_score_plain(x), 10), *k1_bound(x))
    g = torch.Generator(device=device).manual_seed(2)
    cases = [(f"hamming_match {Q}x1024 {'cols' if cols else 'rows'}",
              *_k2_inputs(g, Q, 1024, "random", device), cols)
             for Q in (1024, 2048) for cols in (True, False)]
    cases += [(f"hamming_match path {name} {'cols' if cols else 'rows'}", dq, dt, mask, cols)
              for name, (dq, dt, mask, cols) in path_masks.items() if name != "whole_map"]
    # the whole-map search (phase 20): one shard's (1024, 8192) block of the
    # 32768-row landmark table on the 4-shard mesh, and the whole table
    fd, fv, lm_desc, lm_valid = path_masks["whole_map"]
    cases += [(f"hamming_match whole-map {fd.shape[0]}x{T} rows", fd,
               lm_desc[:T].contiguous(), fv[:, None] & lm_valid[None, :T], False)
              for T in (8192, 32768)]
    for label, dq, dt, mask, cols in cases:
        rows[label] = (
            *cuda_ms(lambda: matching.hamming_match(dq, dt, mask, cols), 50, host=True),
            cuda_ms(lambda: matching.match_plain(dq, dt, mask, cols), 10),
            *k2_bound(dq, dt, mask, cols))
    for label, dq, dt, mask, cols in cases:
        log(f"[profile] {card}: {label} device ms per call by kernel: "
            f"{profiled_ms(lambda: matching.hamming_match(dq, dt, mask, cols))}")
    log(f"[profile] {card}: fast_score 2x2380x752 device ms per call by kernel: "
        f"{profiled_ms(lambda: fast.fast_score_batch(x))}")
    for label, (k_ms, h_ms, p_ms, b_ms, b_by) in rows.items():
        pr1 = PR1_MS.get(label)
        log(f"[timing] {card}: {label} kernel_ms={k_ms!r} host_enqueue_ms={h_ms!r} "
            f"bound_ms={b_ms!r} ({b_by}) "
            f"plain_ms={p_ms!r} pr1_ms={pr1!r}"
            + ("" if pr1 is None else f" below_pr1={k_ms < pr1}"))
    return rows


def make_loop_sequence():
    """tests/test_e2e_loop.py's revisit scenario at 752x480 with the bench's
    camera: 88 frames around a 72-frame lap facing a sprite wall, with
    2-gray-level Gaussian sensor noise, from the port's numpy generator."""
    from orb_slam3_vio_fixes_tpu_torch.io import synthetic

    rng = np.random.default_rng(5)
    seq = synthetic.make_loop_stereo_sequence(
        rng, n_frames=LOOP_FRAMES, h=480, w=752, fx=458.0, baseline=0.11, radius=3.0,
        wall_radius=9.0, n_points=1400, n_loop=LOOP_LAP)
    noise_l = rng.normal(0, 2.0, seq.imgs_l.shape).astype(np.float32)
    noise_r = rng.normal(0, 2.0, seq.imgs_r.shape).astype(np.float32)
    return seq._replace(imgs_l=quantize(seq.imgs_l + noise_l),
                        imgs_r=quantize(seq.imgs_r + noise_r))


def quantize(imgs):
    return np.clip(np.rint(imgs), 0, 255).astype(np.uint8)


def make_revisit_sequence(seed: int):
    """tests/test_relocalization.py's and tests/test_atlas.py's 12-pose orbit
    at 752x480, with the bench's camera and world density."""
    from orb_slam3_vio_fixes_tpu_torch.io import synthetic

    rng = np.random.default_rng(seed)
    world = synthetic.make_world(rng, n_points=1400, extent=10.0, depth_range=(3.0, 14.0))
    R_wc, t_wc = synthetic.orbit_trajectory(12, 0.05, speed=(0.8, 0.0, 0.1),
                                            yaw_rate=0.05)
    K = np.array([[458.0, 0, 376.0], [0, 458.0, 240.0], [0, 0, 1]], np.float32)
    seq = synthetic.render_stereo_along(world, K, R_wc, t_wc, np.arange(12) * 0.05, 480,
                                        752, 0.11)
    return seq._replace(imgs_l=quantize(seq.imgs_l), imgs_r=quantize(seq.imgs_r))


def loop_closer(seq, vocab, device, mesh=None, **cfg):
    """A LoopCloser over the bench configuration's keyframe capacity."""
    from orb_slam3_vio_fixes_tpu_torch.frontend import loop_closing as lc
    from orb_slam3_vio_fixes_tpu_torch.frontend.tracking import octave_inv_sigma2

    tcfg = tracker_config(seq)
    return lc.LoopCloser(vocab, camera_of(seq), tcfg.map.max_keyframes,
                         octave_inv_sigma2(tcfg.orb, device), lc.LoopConfig(**cfg),
                         bf=seq.K[0, 0] * seq.baseline, n_levels=tcfg.orb.n_levels,
                         scale=tcfg.orb.scale, mesh=mesh, device=device)


def build_kf4_tracker(seq, device, **kw):
    """bench.build_tracker()'s configuration with a keyframe at least every 4
    frames (the bench's 20 leaves too few for the loop's min_gap_kfs)."""
    from orb_slam3_vio_fixes_tpu_torch.frontend import tracking

    return tracking.StereoTracker(camera_of(seq), seq.K[0, 0] * seq.baseline,
                                  tracker_config(seq, max_frames_between_kf=4),
                                  device=device, **kw)


def loop_metrics(seq, tr):
    """(ATE, revisit gap): frames k and k + lap share a true pose."""
    from orb_slam3_vio_fixes_tpu_torch.evaluation import ate

    traj = tr.trajectory
    est_ts = np.array([x[0] for x in traj])
    C = np.array([-R.T @ t for _, R, t in traj])
    if not np.all(np.isfinite(C)) or C.shape != (LOOP_FRAMES, 3):
        raise RuntimeError(f"bad loop trajectory: shape {C.shape}")
    rmse, _, n = ate.ate_rmse(seq.ts, seq.t_wc, est_ts, C)
    if n != LOOP_FRAMES:
        raise RuntimeError(f"ATE over {n} of {LOOP_FRAMES} frames")
    k = np.arange(LOOP_FRAMES - LOOP_LAP)
    return rmse, float(np.mean(np.linalg.norm(C[k + LOOP_LAP] - C[k], axis=1)))


def frame_stats(per_frame) -> str:
    ms_arr = 1e3 * np.asarray(per_frame[1:])
    return (f"fps={len(ms_arr) / (ms_arr.sum() / 1e3):.3f} "
            f"frame_ms p50={np.percentile(ms_arr, 50):.2f} "
            f"p95={np.percentile(ms_arr, 95):.2f} max={ms_arr.max():.2f}")


@contextlib.contextmanager
def ms_per_call(owner, name):
    """Time each call of owner.name (synchronised). Yields the list of
    milliseconds per call."""
    fn = getattr(owner, name)
    calls = []

    def wrapper(*a, **k):
        sync()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        sync()
        calls.append(1e3 * (time.perf_counter() - t0))
        return out

    with mock.patch.object(owner, name, wrapper):
        yield calls


def k1_on_frames(label, seq, frames, device) -> None:
    from orb_slam3_vio_fixes_tpu_torch.ops import fast

    for i in frames:
        x = atlases_of(seq, i, device)
        got, ref = fast.fast_score_batch(x), fast.fast_score_plain(x)
        sync()
        n_bad = int((got != ref).sum())
        log(f"[k1] {label} frame {i}: mismatches={n_bad} nonzero={int((ref > 0).sum())}")
        if n_bad:
            raise RuntimeError(f"K1 disagrees with its plain twin on {label} frame {i}")


def k2_on_masks(label, masks, keys) -> None:
    for key in keys:
        if key not in masks:
            raise RuntimeError(f"no {key} matcher call on the {label} path")
        dq, dt, mask, _ = masks[key]
        log(f"[k2] {label} path mask {key}: shape={tuple(mask.shape)} "
            f"density={float(mask.float().mean())!r} admissible={int(mask.sum())}")
        if not bool(mask.any()):
            raise RuntimeError(f"the {label} path's {key} masks admit no pair")
        _k2_compare(f"{label} {key}", dq, dt, mask)


def check_launches(label, counts, n_frames, min_k2) -> None:
    if counts["fast_score"] != n_frames:
        raise RuntimeError(f"{label}: K1 launched {counts['fast_score']} times for "
                           f"{n_frames} frames")
    if counts["hamming_match"] < min_k2:
        raise RuntimeError(f"{label}: K2 launched {counts['hamming_match']} times for at "
                           f"least {min_k2} matcher calls")


def loop_path(seq, vocab, device, card) -> dict:
    """Phase 8: the loop scenario without and with the loop closer; the
    second pass is counted, its loop stages and corrections timed
    (synchronised). Checks the correction, its margins and the ATE,
    and holds K1 and K2 against their plain twins on this path's inputs."""
    from orb_slam3_vio_fixes_tpu_torch import kernels
    from orb_slam3_vio_fixes_tpu_torch import profile_track as pt
    from orb_slam3_vio_fixes_tpu_torch.frontend import loop_closing as lc
    from orb_slam3_vio_fixes_tpu_torch.frontend import tracking
    from orb_slam3_vio_fixes_tpu_torch.frontend.tracking import TrackState
    from orb_slam3_vio_fixes_tpu_torch.ops import matching
    from orb_slam3_vio_fixes_tpu_torch.optim import global_ba, pose_graph

    t0 = time.perf_counter()
    tr_off, per_off = run_pass(seq, device, build=build_kf4_tracker)
    ate_off, gap_off = loop_metrics(seq, tr_off)
    log(f"[loop] without the closer: state={tr_off.track_state} "
        f"keyframes={len(tr_off.kf_order)} ate_rmse_m={ate_off!r} revisit_gap_m={gap_off!r} "
        f"wall={time.perf_counter() - t0:.1f}s")
    log(f"[timing] {card}: loop scenario without the closer {frame_stats(per_off)}")
    del tr_off
    stages = [(lc, "kf_histogram", "histogram"), (lc, "detect_candidates", "query"),
              (lc, "verify_candidate", "verify"),
              (pose_graph, "optimize_pose_graph", "pose_graph"),
              (global_ba, "run_global_ba", "global_ba"),
              (tracking.StereoTracker, "_loop_seam_fuse", "seam_fuse"),
              (tracking.StereoTracker, "_loop_weld_ba", "welding_ba")]
    keys = ("verify_candidate", "verify_candidate/match_descriptors")
    record, tagged, masks = matcher_recorder(set(keys), densest=True)
    closer = loop_closer(seq, vocab, device, min_gap_kfs=8, n_consistency=2,
                         fix_scale=True)
    sync()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with mock.patch.object(matching, "hamming_match", record), \
            mock.patch.object(lc, "verify_candidate",
                              tagged("verify_candidate", lc.verify_candidate)), \
            mock.patch.object(matching, "match_descriptors",
                              tagged("match_descriptors", matching.match_descriptors)), \
            ms_per_call(lc.LoopCloser, "_correct") as corrections, \
            pt.stage_timers(stages) as times:
        tr, per_on = run_pass(seq, device,
                              build=lambda s, d: build_kf4_tracker(s, d, loop_closer=closer))
    sync()
    counts = kernels.launch_counts()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    ate_on, gap_on = loop_metrics(seq, tr)
    bound = ATE_FACTOR * JAX_LOOP_ATE_M + ATE_SLACK_M
    best = max(closer.hits, key=lambda h: h["n_m"]) if closer.hits else None
    n_ins = tr._kf_seq
    n_verify = len(times.get("verify", []))
    # the stereo path's matcher calls, and 3 per verified candidate
    min_k2 = LOOP_FRAMES + 2 * (LOOP_FRAMES - 1) + 6 * n_ins + 3 * n_verify
    log(f"[loop] with the closer: state={tr.track_state} keyframes={len(tr.kf_order)} "
        f"keyframe_inserts={n_ins} corrections={closer.n_corrections} "
        f"hits={closer.hits} best={best} ate_rmse_m={ate_on!r} bound_m={bound!r} "
        f"(jax {JAX_LOOP_ATE_M!r}) revisit_gap_m={gap_on!r} (without {gap_off!r}) "
        f"launches={counts} min_matcher_calls={min_k2} "
        f"peak_device_mib={peak / 2**20:.1f} wall={wall:.1f}s")
    log(f"[timing] {card}: loop scenario with the closer, stages synchronised "
        f"{frame_stats(per_on)}")
    pt.print_stages(times, prefix=f"[stages] {card}: loop")
    for label, ts in times.items():
        log(f"[stages] {card}: loop {label} per_keyframe_ms="
            f"{1e3 * sum(ts) / max(n_ins, 1):.3f} over {n_ins} keyframe inserts")
    for i, ms in enumerate(corrections):
        log(f"[loop] {card}: correction {i}: wall_ms={ms:.1f}")
    if tr.track_state != TrackState.OK:
        raise RuntimeError(f"loop final track state {tr.track_state}")
    if closer.n_corrections < 1 or best is None:
        raise RuntimeError("the loop never closed on the revisit")
    cfg = closer.cfg
    if (best["n_m"] < 2 * cfg.min_bow_matches or best["n_ransac"] < 2 * cfg.min_sim3_inliers
            or best["n_proj"] < 2 * cfg.min_proj_matches):
        raise RuntimeError(f"best loop hit without 2x headroom over the gates: {best}")
    if not ate_on < ate_off:
        raise RuntimeError(f"loop closing did not improve the ATE: {ate_off} -> {ate_on}")
    if not gap_on < 0.8 * gap_off:
        raise RuntimeError(f"revisit gap {gap_on} not below 0.8 x {gap_off}")
    if not ate_on <= bound:
        raise RuntimeError(f"loop ATE {ate_on} m over the bound {bound} m")
    check_launches("loop", counts, LOOP_FRAMES, min_k2)
    k1_on_frames("loop", seq, (0, LOOP_FRAMES - 1), device)
    k2_on_masks("loop", masks, keys)
    return counts


def blank_pair():
    blank = np.zeros((480, 752), np.uint8)
    return blank, blank


def reloc_path(vocab, device, card) -> dict:
    """Phase 9: tests/test_relocalization.py's blackout at full width: 12
    frames, 4 blank frames, then a jump to frame 6's pose."""
    from orb_slam3_vio_fixes_tpu_torch import kernels
    from orb_slam3_vio_fixes_tpu_torch.frontend import relocalization as rl
    from orb_slam3_vio_fixes_tpu_torch.frontend.tracking import TrackState
    from orb_slam3_vio_fixes_tpu_torch.ops import matching

    seq = make_revisit_sequence(3)
    closer = loop_closer(seq, vocab, device, min_gap_kfs=10**6)
    reloc = rl.Relocalizer(vocab, lambda: closer.db, device=device)
    record, tagged, masks = matcher_recorder({"reloc_attempt"}, densest=True)
    sync()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with mock.patch.object(matching, "hamming_match", record), \
            mock.patch.object(rl, "reloc_attempt", tagged("reloc_attempt", rl.reloc_attempt)):
        tr = build_kf4_tracker(seq, device, loop_closer=closer, relocalizer=reloc)
        for i in range(12):
            tr.process_stereo(seq.imgs_l[i], seq.imgs_r[i], seq.ts[i])
        state_before = tr.track_state
        for j in range(4):
            tr.process_stereo(*blank_pair(), 0.6 + 0.05 * j)
        state_lost = tr.track_state
        t1 = time.perf_counter()
        tr.process_stereo(seq.imgs_l[6], seq.imgs_r[6], 0.8)
        sync()
        reloc_ms = 1e3 * (time.perf_counter() - t1)
    counts = kernels.launch_counts()
    C = -tr.R.cpu().numpy().T @ tr.t.cpu().numpy()
    err = float(np.linalg.norm(C - seq.t_wc[6]))
    log(f"[reloc] states={state_before}/{state_lost}/{tr.track_state} "
        f"keyframes={len(tr.kf_order)} n_success={reloc.n_success} centre_err_m={err!r} "
        f"relocalising_frame_ms={reloc_ms:.1f} launches={counts} "
        f"peak_device_mib={torch.cuda.max_memory_allocated() / 2**20:.1f} "
        f"wall={time.perf_counter() - t0:.1f}s")
    if state_before != TrackState.OK or state_lost not in (TrackState.RECENTLY_LOST,
                                                           TrackState.LOST):
        raise RuntimeError(f"reloc states {state_before} / {state_lost}")
    if tr.track_state != TrackState.OK or reloc.n_success != 1 or not err < 0.05:
        raise RuntimeError(f"relocalisation failed: {tr.track_state} "
                           f"n_success={reloc.n_success} centre error {err} m")
    check_launches("reloc", counts, 17, 12 + 2 * 11)
    k1_on_frames("reloc", seq, (0, 6), device)
    k2_on_masks("reloc", masks, ("reloc_attempt",))
    return counts


def _centres(state):
    return -(state.kf_R.transpose(1, 2) @ state.kf_t[..., None])[..., 0]


def first_call_probe(owner, name):
    """(patch, probe): the patch records, without changing it, each call of
    owner.name: the number of calls, and a copy of the first call's input
    state and arguments and of its result."""
    probe = {"calls": 0}
    real = getattr(owner, name)

    def call(state, *a, **k):
        probe["calls"] += 1
        if "input" in probe:
            return real(state, *a, **k)
        probe["input"] = (clone_state(state), a, dict(k))
        out, n = real(state, *a, **k)
        probe["output"] = (clone_state(out), int(n))
        return out, n

    return mock.patch.object(owner, name, call), probe


def mesh_loop(vocab, device, card) -> dict:
    """Phase 20 (a): phase 8's loop scene through the StereoTracker with a
    LoopCloser on a 4-shard mesh of this card. Gates: a correction, every
    correction's global BA landmark-sharded, the ATE within phase 8's bound;
    the first correction's GBA input solved by the unsharded
    global_ba.run_global_ba within MESH_CENTRE_M / MESH_LM_MEDIAN_M, and by
    the sharded solve twice more, every byte equal to the run's."""
    from orb_slam3_vio_fixes_tpu_torch import kernels
    from orb_slam3_vio_fixes_tpu_torch.frontend.tracking import TrackState
    from orb_slam3_vio_fixes_tpu_torch.optim import global_ba
    from orb_slam3_vio_fixes_tpu_torch.parallel import Mesh, sharded_ba

    seq = make_loop_sequence()
    mesh = Mesh([device] * MESH_SHARDS, ("lm",))
    closer = loop_closer(seq, vocab, device, mesh=mesh, min_gap_kfs=8, n_consistency=2,
                         fix_scale=True)
    patch, probe = first_call_probe(sharded_ba, "distributed_global_ba")
    single_patch, single = first_call_probe(global_ba, "run_global_ba")
    sync()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with patch, single_patch:
        tr, per = run_pass(seq, device,
                           build=lambda s, d: build_kf4_tracker(s, d, loop_closer=closer))
    sync()
    counts = kernels.launch_counts()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    ate_on, gap_on = loop_metrics(seq, tr)
    bound = ATE_FACTOR * JAX_LOOP_ATE_M + ATE_SLACK_M
    log(f"[mesh] loop on {mesh}: state={tr.track_state} keyframes={len(tr.kf_order)} "
        f"corrections={closer.n_corrections} sharded_gbas={probe['calls']} "
        f"unsharded_gbas={single['calls']} ate_rmse_m={ate_on!r} bound_m={bound!r} "
        f"revisit_gap_m={gap_on!r} launches={counts} peak_device_mib={peak / 2**20:.1f} "
        f"wall={wall:.1f}s")
    log(f"[timing] {card}: mesh loop scenario {frame_stats(per)}")
    if tr.track_state != TrackState.OK or closer.n_corrections < 1:
        raise RuntimeError(f"mesh loop: state {tr.track_state}, "
                           f"{closer.n_corrections} corrections")
    if probe["calls"] != closer.n_corrections or single["calls"]:
        raise RuntimeError(f"mesh loop: {probe['calls']} sharded and {single['calls']} "
                           f"unsharded global BAs for {closer.n_corrections} corrections")
    if not ate_on <= bound:
        raise RuntimeError(f"mesh loop ATE {ate_on} m over the bound {bound} m")
    check_launches("mesh loop", counts, LOOP_FRAMES,
                   LOOP_FRAMES + 2 * (LOOP_FRAMES - 1) + 6 * tr._kf_seq)
    # the first correction's global BA, unsharded and sharded again
    state, a, k = probe["input"]
    ref, n_ref = probe["output"]
    runs = {}
    for name, fn in (("unsharded", lambda s: global_ba.run_global_ba(s, *a[:3], 0, **{
                         key: v for key, v in k.items() if key in ("n_levels", "scale")})),
                     ("sharded_1", lambda s: sharded_ba.distributed_global_ba(s, *a, **k)),
                     ("sharded_2", lambda s: sharded_ba.distributed_global_ba(s, *a, **k))):
        inp = clone_state(state)
        sync()
        t1 = time.perf_counter()
        out, n = fn(inp)
        sync()
        runs[name] = (out, int(n), 1e3 * (time.perf_counter() - t1))
    kv = ref.kf_valid
    single_out, n_single, ms_single = runs["unsharded"]
    dc = float((_centres(ref) - _centres(single_out))[kv].norm(dim=-1).max())
    lm_med = float((ref.lm_pos - single_out.lm_pos)[ref.lm_valid].norm(dim=-1).median())
    same = all(torch.equal(getattr(runs[r][0], f), getattr(ref, f))
               for r in ("sharded_1", "sharded_2") for f in ref._fields
               if isinstance(getattr(ref, f), torch.Tensor))
    same = same and runs["sharded_1"][1] == runs["sharded_2"][1] == n_ref
    log(f"[mesh] {card}: first correction's GBA (K={int(kv.sum())} keyframes, "
        f"{int(ref.lm_valid.sum())} landmarks): sharded vs unsharded centre_max_m={dc!r} "
        f"landmark_median_m={lm_med!r} inliers={n_ref} unsharded={n_single}; "
        f"two more sharded runs byte-identical={same}; ms per sharded GBA "
        f"{runs['sharded_1'][2]:.1f} / {runs['sharded_2'][2]:.1f}, unsharded "
        f"{ms_single:.1f}")
    if not (dc < MESH_CENTRE_M and lm_med < MESH_LM_MEDIAN_M):
        raise RuntimeError(f"the sharded GBA parts from the unsharded one: {dc} m, {lm_med} m")
    if not same:
        raise RuntimeError("two runs of the sharded GBA on one input differ")
    return counts


def mesh_reloc(vocab, device, card) -> dict:
    """Phase 20 (b): phase 9's blackout through a Relocalizer on a 4-shard
    mesh (axis "db") of this card. Gates: OK again with the hit from the
    whole-map search (n_success_global >= 1), the centre within 5 cm, and
    each search one K2 launch per shard."""
    from orb_slam3_vio_fixes_tpu_torch import kernels
    from orb_slam3_vio_fixes_tpu_torch.frontend import relocalization as rl
    from orb_slam3_vio_fixes_tpu_torch.frontend.tracking import TrackState
    from orb_slam3_vio_fixes_tpu_torch.parallel import Mesh
    from orb_slam3_vio_fixes_tpu_torch.parallel import sharded_matching as sm

    seq = make_revisit_sequence(3)
    mesh = Mesh([device] * MESH_SHARDS, ("db",))
    closer = loop_closer(seq, vocab, device, min_gap_kfs=10**6)
    reloc = rl.Relocalizer(vocab, lambda: closer.db, mesh=mesh, device=device)
    searches = []
    real = sm.sharded_match

    def search(*a, **k):
        sync()
        n0, t1 = kernels.launch_counts()["hamming_match"], time.perf_counter()
        out = real(*a, **k)
        sync()
        searches.append((kernels.launch_counts()["hamming_match"] - n0,
                         1e3 * (time.perf_counter() - t1), tuple(a[2].shape)))
        return out

    sync()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with mock.patch.object(sm, "sharded_match", search):
        tr = build_kf4_tracker(seq, device, loop_closer=closer, relocalizer=reloc)
        for i in range(12):
            tr.process_stereo(seq.imgs_l[i], seq.imgs_r[i], seq.ts[i])
        state_before = tr.track_state
        for j in range(4):
            tr.process_stereo(*blank_pair(), 0.6 + 0.05 * j)
        state_lost = tr.track_state
        tr.process_stereo(seq.imgs_l[6], seq.imgs_r[6], 0.8)
        sync()
    counts = kernels.launch_counts()
    C = -tr.R.cpu().numpy().T @ tr.t.cpu().numpy()
    err = float(np.linalg.norm(C - seq.t_wc[6]))
    log(f"[mesh] reloc on {mesh}: states={state_before}/{state_lost}/{tr.track_state} "
        f"n_success={reloc.n_success} n_success_global={reloc.n_success_global} "
        f"centre_err_m={err!r} searches={len(searches)} launches={counts} "
        f"peak_device_mib={torch.cuda.max_memory_allocated() / 2**20:.1f} "
        f"wall={time.perf_counter() - t0:.1f}s")
    for n_k2, ms, shape in searches:
        log(f"[timing] {card}: sharded whole-map search of a {shape[0]}-row table on "
            f"{MESH_SHARDS} shards: ms={ms:.2f} k2_launches={n_k2}")
    if tr.track_state != TrackState.OK or reloc.n_success_global < 1 or not err < 0.05:
        raise RuntimeError(f"mesh relocalisation failed: {tr.track_state} "
                           f"n_success_global={reloc.n_success_global} centre error {err} m")
    if not searches or any(n_k2 != MESH_SHARDS for n_k2, _, _ in searches):
        raise RuntimeError(f"K2 launches per whole-map search {[x[0] for x in searches]}, "
                           f"not {MESH_SHARDS}")
    return counts


def mesh_path(vocab, device, card) -> dict:
    """Phase 20: the mesh paths on one card, every shard on it: (a) the
    loop scene with a sharded global BA, (b) the blackout with the sharded
    whole-map search, (c) dryrun.dryrun_multichip(4) with full bind parity,
    and the dense distributed BA step twice on one input, byte-identical."""
    from orb_slam3_vio_fixes_tpu_torch import dryrun
    from orb_slam3_vio_fixes_tpu_torch.optim import ba_core
    from orb_slam3_vio_fixes_tpu_torch.parallel import Mesh, sharded_ba
    from orb_slam3_vio_fixes_tpu_torch.slam_map import map_state as ms

    out = {"mesh_loop": mesh_loop(vocab, device, card),
           "mesh_reloc": mesh_reloc(vocab, device, card)}
    t0 = time.perf_counter()
    dry = dryrun.dryrun_multichip(MESH_SHARDS, device=device)
    sync()
    log(f"[mesh] dryrun_multichip({MESH_SHARDS}) on {card}: {dry} "
        f"wall={time.perf_counter() - t0:.1f}s")
    if not (dry["both"] > 0 and dry["parity"] == dry["both"]):
        raise RuntimeError(f"sharded bind parity {dry['parity']}/{dry['both']}")
    # the dense distributed step (a (6P)^2 solve on the card) twice on the
    # realistic map's problem
    state, *_, cam, bf = dryrun.realistic_map(device)
    K = state.kf_R.shape[0]
    pose_idx, lm_idx, uvr, inv_s2, valid = ms.ba_factors_from_map(
        state, torch.arange(K, device=device), torch.ones(8, device=device))
    fixed = torch.zeros(K, dtype=torch.bool, device=device)
    fixed[0] = True
    problem = ba_core.BAProblem(state.kf_R, state.kf_t, fixed, state.lm_pos, state.lm_valid,
                                torch.zeros_like(state.lm_valid),
                                ba_core.ReprojFactors(pose_idx, lm_idx, uvr, inv_s2, valid),
                                cam, bf)
    part = sharded_ba.partition_problem(problem, MESH_SHARDS)
    mesh = Mesh([device] * MESH_SHARDS, ("lm",))
    dense = [sharded_ba.distributed_bundle_adjust(part, mesh,
                                                  ba_core.LMConfig(n_rounds=1, n_iters=2))
             for _ in range(2)]
    same = all(torch.equal(x, y) for x, y in zip((dense[0][0].R, dense[0][0].t,
                                                  dense[0][0].lm, dense[0][2]),
                                                 (dense[1][0].R, dense[1][0].t,
                                                  dense[1][0].lm, dense[1][2])))
    log(f"[mesh] dense distributed BA (P={K}, {int(valid.sum())} factors) twice: "
        f"byte-identical={same}")
    if not same:
        raise RuntimeError("two runs of the dense distributed BA on one input differ")
    return out


def snapshot_check(label, tr, atlas, closer, vocab, device) -> None:
    """Phase 11: save the Atlas (active map, stored maps, histograms, the
    vocabulary), load it back and require every array equal."""
    import tempfile

    from orb_slam3_vio_fixes_tpu_torch import convert
    from orb_slam3_vio_fixes_tpu_torch.slam_map import snapshot

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/atlas.npz"
        snapshot.save_atlas(path, tr.state, tr.cfg.map, tr.n_kf, tr.n_lm, tr.kf_order,
                            atlas.stored, hists=closer.db.hist, vocab=vocab)
        size = os.path.getsize(path)
        state, cfg, meta, hists, stored, v2 = snapshot.load_atlas(path, vocab=vocab,
                                                                  device=device)
    pairs = [("active", tr.state, state)] + [
        (f"stored{i}", sm.state, st[0]) for i, (sm, st) in enumerate(zip(atlas.stored, stored))]
    bad = [f"{name}.{f}" for name, a, b in pairs
           for f, x in convert.map_state_to_numpy(a).items()
           if not np.array_equal(x, convert.map_state_to_numpy(b)[f])]
    if not np.array_equal(hists, closer.db.hist.cpu().numpy()):
        bad.append("hists")
    bad += [f"stored{i}.hists" for i, (sm, st) in enumerate(zip(atlas.stored, stored))
            if not np.array_equal(sm.hists, st[3])]
    if (len(stored) != len(atlas.stored) or meta["kf_order"] != list(tr.kf_order)
            or tuple(cfg) != tuple(tr.cfg.map) or v2 is None
            or not torch.equal(v2.nodes, vocab.nodes)):
        bad.append("meta")
    log(f"[snapshot] {label}: stored_maps={len(stored)} bytes={size} "
        f"seconds={time.perf_counter() - t0:.2f} mismatching={bad}")
    if bad:
        raise RuntimeError(f"snapshot round trip differs: {bad}")


def atlas_path(vocab, device, card) -> dict:
    """Phase 10: tests/test_atlas.py's scenario at full width: the tracker
    stashes its map after 3 lost frames, starts a new one on the replay and
    merges it into the stored map on the revisit; the Atlas is saved and
    loaded back after the stash and after the merge (phase 11)."""
    from orb_slam3_vio_fixes_tpu_torch import kernels
    from orb_slam3_vio_fixes_tpu_torch.frontend import tracking
    from orb_slam3_vio_fixes_tpu_torch.frontend.tracking import TrackState
    from orb_slam3_vio_fixes_tpu_torch.ops import matching
    from orb_slam3_vio_fixes_tpu_torch.slam_map import atlas as atlas_mod

    seq = make_revisit_sequence(5)
    cfg = tracker_config(seq, max_frames_between_kf=3)
    closer = loop_closer(seq, vocab, device, min_gap_kfs=10**6)
    atl = atlas_mod.Atlas(cfg.map, vocab, camera_of(seq),
                          tracking.octave_inv_sigma2(cfg.orb, device),
                          atlas_mod.AtlasConfig(min_stash_kfs=3), device=device)
    record, tagged, masks = matcher_recorder({"verify_cross_candidate"}, densest=True)
    sync()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with mock.patch.object(matching, "hamming_match", record), \
            mock.patch.object(atlas_mod, "verify_cross_candidate",
                              tagged("verify_cross_candidate",
                                     atlas_mod.verify_cross_candidate)):
        tr = tracking.StereoTracker(camera_of(seq), seq.K[0, 0] * seq.baseline, cfg,
                                    device=device, loop_closer=closer, atlas=atl)
        tr.max_lost_frames = 3
        for i in range(12):
            tr.process_stereo(seq.imgs_l[i], seq.imgs_r[i], seq.ts[i])
        first = (tr.track_state, tr.n_kf)
        for j in range(6):
            tr.process_stereo(*blank_pair(), 0.6 + 0.05 * j)
        stashed = (len(atl.stored), tr.map_id, tr.track_state)
        snapshot_check("after the stash", tr, atl, closer, vocab, device)
        for i in range(2, 12):
            tr.process_stereo(seq.imgs_l[i], seq.imgs_r[i], 0.9 + seq.ts[i])
    sync()
    counts = kernels.launch_counts()
    C = -tr.R.cpu().numpy().T @ tr.t.cpu().numpy()
    err = float(np.linalg.norm(C - seq.t_wc[11]))
    log(f"[atlas] first map {first} stashed (stored, map_id, state)={stashed} "
        f"final state={tr.track_state} merges={atl.n_merges} stored={len(atl.stored)} "
        f"map_id={tr.map_id} keyframes={len(tr.kf_order)} centre_err_m={err!r} "
        f"launches={counts} peak_device_mib={torch.cuda.max_memory_allocated() / 2**20:.1f} "
        f"wall={time.perf_counter() - t0:.1f}s")
    if first[0] != TrackState.OK or first[1] < 3:
        raise RuntimeError(f"atlas first map: {first}")
    if stashed != (1, 1, TrackState.NOT_INITIALIZED):
        raise RuntimeError(f"atlas stash: {stashed}")
    if (tr.track_state != TrackState.OK or atl.n_merges != 1 or atl.stored
            or tr.map_id != 2 or not err < 0.10):
        raise RuntimeError(f"atlas merge failed: state {tr.track_state} merges "
                           f"{atl.n_merges} map_id {tr.map_id} centre error {err} m")
    check_launches("atlas", counts, 28, 12 + 2 * 11)
    snapshot_check("after the merge", tr, atl, closer, vocab, device)
    k1_on_frames("atlas", seq, (2, 11), device)
    k2_on_masks("atlas", masks, ("verify_cross_candidate",))
    return counts


def make_si_loop_sequence(n_loop: int = SI_LOOP_LAP, n_frames: int = SI_LOOP_FRAMES,
                          noise_seed=None, synthetic=None):
    """tests/test_e2e_inertial_loop.py's revisit at 752x480 with the bench's
    camera: the loop scene with exact 200 Hz IMU samples and 2 gray levels
    of image noise, from the port's numpy generator (or the module
    `synthetic`). A `noise_seed` draws the noise from a generator of its own
    and leaves the scene as it is."""
    if synthetic is None:
        from orb_slam3_vio_fixes_tpu_torch.io import synthetic

    rng = np.random.default_rng(5)
    seq = synthetic.make_loop_stereo_inertial_sequence(
        rng, n_frames=n_frames, n_loop=n_loop, h=480, w=752, fx=458.0, baseline=0.11,
        radius=3.0, wall_radius=9.0, n_points=1400)
    if noise_seed is not None:
        rng = np.random.default_rng(noise_seed)
    noise_l = rng.normal(0, 2.0, seq.imgs_l.shape).astype(np.float32)
    noise_r = rng.normal(0, 2.0, seq.imgs_r.shape).astype(np.float32)
    return seq._replace(imgs_l=quantize(seq.imgs_l + noise_l),
                        imgs_r=quantize(seq.imgs_r + noise_r))


def build_si_loop_tracker(seq, device, lost_time=None, **kw):
    """The stereo-inertial revisit's tracker: the bench configuration with a
    keyframe at least every 4 frames, the test's inertial configuration and
    search radii; `kw` passes a loop closer, relocaliser or Atlas."""
    from orb_slam3_vio_fixes_tpu_torch.frontend import inertial_tracking as it
    from orb_slam3_vio_fixes_tpu_torch.imu import preintegration as pre

    icfg = it.InertialConfig(**SI_LOOP_ICFG)
    if lost_time is not None:
        icfg = icfg._replace(recently_lost_time=lost_time)
    calib = pre.ImuCalib.make(1.7e-4, 2e-3, 1.9e-5, 3e-3, seq.imu_hz, device=device)
    tr = it.StereoInertialTracker(camera_of(seq), seq.K[0, 0] * seq.baseline, calib,
                                  tracker_config(seq, max_frames_between_kf=4), icfg,
                                  device=device, **kw)
    tr.match_radius = SI_LOOP_RADIUS
    return tr


def trajectory_ate(ts, t_wc, tr, n_frames):
    """ATE of the tracker's whole trajectory, which must hold n_frames finite
    poses, against the true centres t_wc at stamps ts."""
    from orb_slam3_vio_fixes_tpu_torch.evaluation import ate

    traj = tr.trajectory
    C = np.array([-R.T @ t for _, R, t in traj])
    if not np.all(np.isfinite(C)) or C.shape != (n_frames, 3):
        raise RuntimeError(f"bad trajectory: shape {C.shape}")
    rmse, _, n = ate.ate_rmse(ts[:n_frames], t_wc[:n_frames],
                              np.array([x[0] for x in traj]), C)
    if n != n_frames:
        raise RuntimeError(f"ATE over {n} of {n_frames} frames")
    return rmse


def gravity_and_velocity(seq, kf_R, kf_t, kf_ts, kf_vel):
    """tests/test_e2e_inertial_loop.py's checks on the corrected map, from
    the live keyframes' rows in order (numpy): the angle between estimated
    and true body-frame gravity at every keyframe (degrees), and the median
    relative error of the keyframe velocities against central differences
    of the keyframe centres."""
    dt = seq.ts[1] - seq.ts[0]
    fi = np.rint(kf_ts / dt).astype(int)
    keep = fi < len(seq.ts)
    g_est = kf_R[keep] @ np.array([0.0, 0.0, -1.0])
    g_true = np.einsum("kji,j->ki", seq.R_wc[fi[keep]], np.array([0.0, -1.0, 0.0]))
    errs = np.degrees(np.arccos(np.clip((g_est * g_true).sum(-1), -1.0, 1.0)))
    C = np.einsum("kji,kj->ki", kf_R, -kf_t)
    v_fd = (C[2:] - C[:-2]) / (kf_ts[2:] - kf_ts[:-2])[:, None]
    v_kf = kf_vel[1:-1]
    speed = np.linalg.norm(v_kf, axis=1)
    ok = speed > 0.1
    v_err = float(np.median(np.linalg.norm(v_fd - v_kf, axis=1)[ok] / speed[ok]))
    return errs, v_err


def si_loop_path(vocab, device, card) -> dict:
    """Phase 12: the stereo-inertial revisit without and with an inertial
    LoopCloser (the 10^5-word vocabulary); the second pass counted, its loop
    stages and post-loop full VI BA timed (synchronised). Checks the
    correction, gravity, velocities and ATE, and holds K1 and K2 against
    their plain twins on this path's inputs (K2 on masks captured inside
    verify_candidate)."""
    from orb_slam3_vio_fixes_tpu_torch import kernels
    from orb_slam3_vio_fixes_tpu_torch import profile_track as pt
    from orb_slam3_vio_fixes_tpu_torch.frontend import inertial_tracking as it
    from orb_slam3_vio_fixes_tpu_torch.frontend import loop_closing as lc
    from orb_slam3_vio_fixes_tpu_torch.frontend.tracking import TrackState
    from orb_slam3_vio_fixes_tpu_torch.ops import matching
    from orb_slam3_vio_fixes_tpu_torch.optim import pose_graph

    seq = make_si_loop_sequence()
    n = SI_LOOP_FRAMES
    t0 = time.perf_counter()
    tr_off, per_off = run_pass(seq, device, build=build_si_loop_tracker)
    ate_off = trajectory_ate(seq.ts, seq.t_wc, tr_off, n)
    log(f"[si_loop] without the closer: state={tr_off.track_state} "
        f"imu_ready={tr_off.imu_ready} keyframes={len(tr_off.kf_order)} "
        f"ate_rmse_m={ate_off!r} (jax {JAX_SI_LOOP_OFF_ATE_M!r}) "
        f"wall={time.perf_counter() - t0:.1f}s")
    log(f"[timing] {card}: stereo-inertial loop scenario without the closer "
        f"{frame_stats(per_off)}")
    del tr_off
    stages = [(lc, "kf_histogram", "histogram"), (lc, "detect_candidates", "query"),
              (lc, "verify_candidate", "verify"),
              (pose_graph, "optimize_pose_graph", "pose_graph_4dof"),
              (it.StereoInertialTracker, "_post_loop_gba", "post_loop_full_vi_ba")]
    keys = ("verify_candidate", "verify_candidate/match_descriptors")
    record, tagged, masks = matcher_recorder(set(keys), densest=True)
    closer = loop_closer(seq, vocab, device, **SI_LOOP_LCFG)
    probe, gba_probe = first_post_loop_vi_gba()
    sync()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with mock.patch.object(matching, "hamming_match", record), \
            mock.patch.object(lc, "verify_candidate",
                              tagged("verify_candidate", lc.verify_candidate)), \
            mock.patch.object(matching, "match_descriptors",
                              tagged("match_descriptors", matching.match_descriptors)), \
            probe, pt.stage_timers(stages) as times:
        tr, per_on = run_pass(
            seq, device, build=lambda s, d: build_si_loop_tracker(s, d, loop_closer=closer))
    sync()
    counts = kernels.launch_counts()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    ate_on = trajectory_ate(seq.ts, seq.t_wc, tr, n)
    order = np.asarray(tr.kf_order)
    errs, v_err = gravity_and_velocity(
        seq, *(getattr(tr.state, f).cpu().numpy()[order]
               for f in ("kf_R", "kf_t", "kf_ts", "kf_vel")))
    bound = ATE_FACTOR * JAX_SI_LOOP_ATE_M + ATE_SLACK_M
    n_ins = tr._kf_seq
    n_verify = len(times.get("verify", []))
    min_k2 = n + 2 * (n - 1) + 6 * n_ins + 3 * n_verify
    log(f"[si_loop] with the closer: state={tr.track_state} imu_ready={tr.imu_ready} "
        f"keyframes={len(tr.kf_order)} keyframe_inserts={n_ins} "
        f"corrections={closer.n_corrections} hits={closer.hits} ate_rmse_m={ate_on!r} "
        f"bound_m={bound!r} (jax {JAX_SI_LOOP_ATE_M!r}) without_closer_m={ate_off!r} "
        f"gravity_deg_median={float(np.median(errs))!r} gravity_deg_max={float(errs.max())!r} "
        f"(bars {GRAVITY_MEDIAN_DEG!r} / {GRAVITY_MAX_DEG!r}; jax {JAX_SI_LOOP_GRAVITY_DEG}) "
        f"velocity_rel_err={v_err!r} launches={counts} min_matcher_calls={min_k2} "
        f"peak_device_mib={peak / 2**20:.1f} wall={wall:.1f}s")
    log(f"[timing] {card}: stereo-inertial loop scenario with the closer, stages "
        f"synchronised {frame_stats(per_on)}")
    pt.print_stages(times, prefix=f"[stages] {card}: si_loop")
    for label, ts in times.items():
        log(f"[stages] {card}: si_loop {label} per_keyframe_ms="
            f"{1e3 * sum(ts) / max(n_ins, 1):.3f} over {n_ins} keyframe inserts")
    if tr.track_state != TrackState.OK or not tr.imu_ready:
        raise RuntimeError(f"si_loop final state {tr.track_state} imu_ready={tr.imu_ready}")
    if closer.n_corrections < 1:
        raise RuntimeError("the inertial loop never closed on the revisit")
    if not (np.median(errs) < GRAVITY_MEDIAN_DEG and errs.max() < GRAVITY_MAX_DEG):
        raise RuntimeError(f"gravity misaligned after the loop: {errs}")
    if not v_err < VELOCITY_REL_ERR:
        raise RuntimeError(f"velocities inconsistent with the corrected poses: {v_err}")
    if not (ate_on < ate_off and ate_on <= bound):
        raise RuntimeError(f"si_loop ATE {ate_on} m: bound {bound} m, without the "
                           f"closer {ate_off} m")
    check_launches("si_loop", counts, n, min_k2)
    k1_on_frames("si_loop", seq, (0, n - 1), device)
    k2_on_masks("si_loop", masks, keys)
    sharded_vi_gba_check(gba_probe, device, card)
    return counts


def clone_state(state):
    return type(state)(*(f.clone() if isinstance(f, torch.Tensor) else f for f in state))


def first_post_loop_vi_gba():
    """(patch, probe): the patch records, without changing it, the first
    full-map VI BA that an inertial tracker's _post_loop_gba runs: a copy
    of its input state, its other arguments, and a copy of its result."""
    from orb_slam3_vio_fixes_tpu_torch.frontend import inertial_tracking as it
    from orb_slam3_vio_fixes_tpu_torch.optim import vi_global_ba as vg

    probe = {}
    real_gba, real_post = vg.run_global_vi_ba, it.StereoInertialTracker._post_loop_gba

    def post_loop(self, kf_id):
        probe["in_post_loop"] = True
        try:
            return real_post(self, kf_id)
        finally:
            probe["in_post_loop"] = False

    def gba(state, *a, **k):
        if not probe.get("in_post_loop") or "input" in probe:
            return real_gba(state, *a, **k)
        probe["input"] = (clone_state(state), a, dict(k))
        out, n_inl = real_gba(state, *a, **k)
        probe["output"] = (clone_state(out), int(n_inl))
        return out, n_inl

    patch = contextlib.ExitStack()
    patch.enter_context(mock.patch.object(vg, "run_global_vi_ba", gba))
    patch.enter_context(mock.patch.object(it.StereoInertialTracker, "_post_loop_gba",
                                          post_loop))
    return patch, probe


def sharded_vi_gba_check(probe, device, card) -> None:
    """Phase 12's sharded check: the input of its first post-loop full VI BA
    solved again by run_global_vi_ba_sharded on a 4-shard mesh on this card,
    against the unsharded result the phase produced, with
    tests/test_vi_global_ba.py::test_vi_gba_sharded_parity_8_devices's bars:
    keyframe positions within 2e-3 m, every relative rotation's trace above
    3 - 1e-4, the landmark median within 1e-3 m, inliers within 2%."""
    from orb_slam3_vio_fixes_tpu_torch.optim import vi_global_ba as vg
    from orb_slam3_vio_fixes_tpu_torch.parallel import Mesh

    if "input" not in probe:
        raise RuntimeError("no post-loop full VI BA to hold the sharded one against")
    state, a, k = probe["input"]
    ref, n_ref = probe["output"]
    k = {key: v for key, v in k.items() if key not in ("f_budget", "lm_budget")}
    mesh = Mesh([device] * MESH_SHARDS, ("lm",))
    sync()
    t0 = time.perf_counter()
    got, n_got = vg.run_global_vi_ba_sharded(clone_state(state), *a, mesh, **k)
    n_got = int(n_got)
    sync()
    ms_sharded = 1e3 * (time.perf_counter() - t0)
    live = ref.kf_valid & ~a[5]
    dt = float((got.kf_t - ref.kf_t)[ref.kf_valid].abs().max())
    trace = (ref.kf_R[ref.kf_valid] @ got.kf_R[ref.kf_valid].transpose(1, 2)).diagonal(
        dim1=1, dim2=2).sum(-1)
    lm_med = float((got.lm_pos - ref.lm_pos)[ref.lm_valid].norm(dim=-1).median())
    log(f"[si_loop] {card}: sharded VI GBA on {mesh}: kf_t_max_diff_m={dt!r} "
        f"min_rotation_trace={float(trace.min())!r} landmark_median_m={lm_med!r} "
        f"inliers={n_got} unsharded={n_ref} free_keyframes={int(live.sum())} "
        f"sharded_ms={ms_sharded:.1f}")
    if not (dt < 2e-3 and float(trace.min()) > 3 - 1e-4 and lm_med < 1e-3
            and abs(n_got - n_ref) <= 0.02 * max(n_ref, 1)):
        raise RuntimeError("the sharded VI GBA parts from the unsharded one")


def aligned_centre_error(seq, tr, upto: int, frame: int) -> float:
    """Error of the tracker's current camera centre against frame `frame`'s
    true one, after aligning the trajectory's first `upto` frames to the
    truth (the map frame is gravity-aligned after the IMU initialisation)."""
    from orb_slam3_vio_fixes_tpu_torch.evaluation import ate

    traj = tr.trajectory[:upto]
    C = np.array([-R.T @ t for _, R, t in traj])
    s, R, t = ate.horn_align(C, seq.t_wc[:upto])
    c = -tr.R.cpu().numpy().T @ tr.t.cpu().numpy()
    return float(np.linalg.norm(s * R @ c + t - seq.t_wc[frame]))


def si_atlas_path(vocab, device, card) -> dict:
    """Phase 13: relocalisation and the Atlas for the stereo-inertial
    tracker after its IMU initialisation, on a 52-frame lap of the loop
    scene (SI_ATLAS_PLAN), as two runs. Relocalisation (phase 9's blackout):
    map A is built and its IMU initialised, blank frames follow (IMU dead
    reckoning), then a frame shows an earlier view (the camera moved while
    blind): the relocaliser branch must place it inside the dead-reckoning
    window, within 5 cm of where the map had that view. Atlas (phase 10's
    stash and merge): a long blackout runs past the (cut) dead-reckoning
    budget, so map A (>= 10 keyframes) goes to the Atlas; map B starts,
    initialises its IMU and merges into A on the revisit of A's first frames
    through the VI merge BA (centre within 10 cm of the truth, aligned on
    A's frames). The Atlas is saved and loaded back after the stash and
    after the merge."""
    from orb_slam3_vio_fixes_tpu_torch import kernels
    from orb_slam3_vio_fixes_tpu_torch import profile_track as pt
    from orb_slam3_vio_fixes_tpu_torch.frontend import inertial_tracking as it
    from orb_slam3_vio_fixes_tpu_torch.frontend import relocalization as rl
    from orb_slam3_vio_fixes_tpu_torch.frontend import tracking
    from orb_slam3_vio_fixes_tpu_torch.frontend.tracking import TrackState
    from orb_slam3_vio_fixes_tpu_torch.ops import matching
    from orb_slam3_vio_fixes_tpu_torch.slam_map import atlas as atlas_mod

    p = SI_ATLAS_PLAN
    n = p["frames"]
    seq = make_si_loop_sequence(SI_ATLAS_LAP, n)
    cfg = tracker_config(seq, max_frames_between_kf=4)
    blank = blank_pair()
    record, tagged, masks = matcher_recorder({"reloc_attempt", "verify_cross_candidate"},
                                             densest=True)
    stages = [(it.StereoInertialTracker, "_run_full_inertial_ba", "full_vi_ba"),
              (it.StereoInertialTracker, "_post_merge", "vi_merge_ba")]

    def build(**kw):
        closer = loop_closer(seq, vocab, device, min_gap_kfs=10**6)
        return closer, build_si_loop_tracker(seq, device, lost_time=SI_ATLAS_LOST_TIME,
                                             loop_closer=closer, **kw)

    sync()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with mock.patch.object(matching, "hamming_match", record), \
            mock.patch.object(rl, "reloc_attempt", tagged("reloc_attempt", rl.reloc_attempt)), \
            mock.patch.object(atlas_mod, "verify_cross_candidate",
                              tagged("verify_cross_candidate",
                                     atlas_mod.verify_cross_candidate)), \
            pt.stage_timers(stages) as times:
        # relocalisation
        a = p["reloc_map"]
        reloc = rl.Relocalizer(vocab, lambda: closer.db, device=device)
        closer, tr = build(relocalizer=reloc)
        for i in range(a):
            track_frame(tr, seq, i)
        before = (tr.track_state, tr.imu_ready, len(tr.kf_order))
        for i in range(a, a + p["reloc_blank"]):
            tr.process_stereo_inertial(*blank, seq.ts[i], seq.imu[i - 1])
        lost = tr.track_state
        i, v = a + p["reloc_blank"], p["reloc_view"]
        t1 = time.perf_counter()
        tr.process_stereo_inertial(seq.imgs_l[v], seq.imgs_r[v], seq.ts[i], seq.imu[i - 1])
        sync()
        reloc_ms = 1e3 * (time.perf_counter() - t1)
        _, R_v, t_v = tr.trajectory[v]
        c = -tr.R.cpu().numpy().T @ tr.t.cpu().numpy()
        reloc_err = float(np.linalg.norm(c - (-R_v.T @ t_v)))
        after_reloc = (tr.track_state, reloc.n_success, tr.imu_ready)
        n_real = a + 1
        # Atlas: stash and merge
        atl = atlas_mod.Atlas(cfg.map, vocab, camera_of(seq),
                              tracking.octave_inv_sigma2(cfg.orb, device),
                              atlas_mod.AtlasConfig(inertial=True), device=device)
        closer, tr = build(atlas=atl)
        a, i_b = p["atlas_map"], p["atlas_map"] + p["lost_blank"]
        for i in range(a):
            track_frame(tr, seq, i)
        kf_a = len(tr.kf_order)
        for i in range(a, i_b):
            tr.process_stereo_inertial(*blank, seq.ts[i], seq.imu[i - 1])
        stashed = (len(atl.stored), tr.map_id, tr.track_state, tr.imu_ready)
        snapshot_check("si after the stash", tr, atl, closer, vocab, device)
        merge_at = None
        for i in range(i_b, n):
            track_frame(tr, seq, i)
            if atl.n_merges and merge_at is None:
                merge_at = (i, tr.imu_ready, len(times.get("vi_merge_ba", [])))
        n_real += a + n - i_b
    sync()
    counts = kernels.launch_counts()
    err = aligned_centre_error(seq, tr, a, n - 1)
    n_frames = p["reloc_map"] + p["reloc_blank"] + 1 + n
    log(f"[si_atlas] plan={p} relocalisation: map A (state, imu_ready, keyframes)={before}; "
        f"blackout state {lost}; view of frame {v} (state, reloc successes, imu_ready)="
        f"{after_reloc} centre_err_m={reloc_err!r} (against the map's pose of that "
        f"view) relocalising_frame_ms={reloc_ms:.1f}; Atlas: keyframes before the loss "
        f"{kf_a}; after the long blackout (stored, map_id, state, imu_ready)={stashed}; "
        f"merge (frame, imu_ready, VI merge BAs)={merge_at} merges={atl.n_merges} final "
        f"state={tr.track_state} map_id={tr.map_id} keyframes={len(tr.kf_order)} "
        f"centre_err_m={err!r} launches={counts} "
        f"peak_device_mib={torch.cuda.max_memory_allocated() / 2**20:.1f} "
        f"wall={time.perf_counter() - t0:.1f}s")
    pt.print_stages(times, prefix=f"[stages] {card}: si_atlas")
    if before[:2] != (TrackState.OK, True) or lost != TrackState.RECENTLY_LOST:
        raise RuntimeError(f"si_atlas map A {before}, blackout state {lost}")
    if after_reloc != (TrackState.OK, 1, True) or not reloc_err < 0.05:
        raise RuntimeError(f"si relocalisation failed: {after_reloc} centre error {reloc_err}")
    if kf_a < 10 or stashed != (1, 1, TrackState.NOT_INITIALIZED, False):
        raise RuntimeError(f"si atlas stash: {kf_a} keyframes, {stashed}")
    if (merge_at is None or not merge_at[1] or merge_at[2] != 1 or atl.n_merges != 1
            or atl.stored or tr.track_state != TrackState.OK or tr.map_id != 2
            or not err < 0.10):
        raise RuntimeError(f"si atlas merge failed: {merge_at} merges {atl.n_merges} "
                           f"state {tr.track_state} map_id {tr.map_id} centre error {err}")
    snapshot_check("si after the merge", tr, atl, closer, vocab, device)
    # a stereo match per real frame and two tracking matchers per tracked
    # frame (all but the two initialising frames and the relocalising one)
    check_launches("si_atlas", counts, n_frames, n_real + 2 * (n_real - 3))
    k1_on_frames("si_atlas", seq, (0, v), device)
    k2_on_masks("si_atlas", masks, ("reloc_attempt", "verify_cross_candidate"))
    return counts


def facade_path(device, card) -> dict:
    """Phase 14: SLAMSystem on the card for STEREO, RGBD, IMU_STEREO,
    IMU_RGBD, MONOCULAR and IMU_MONOCULAR from a YAML file written here,
    each mode's launches counted;
    the final state and ATE checked, the Atlas saved and loaded back through
    the facade; then configs/EuRoC.yaml parsed by the port's own parser and
    rectified, and the rectifying remap on the card held against the CPU.
    Returns the launch counts and the seconds of each frame per mode."""
    import tempfile

    from orb_slam3_vio_fixes_tpu_torch import convert, kernels
    from orb_slam3_vio_fixes_tpu_torch import system as sysm
    from orb_slam3_vio_fixes_tpu_torch.io import settings as settings_io
    from orb_slam3_vio_fixes_tpu_torch.io import synthetic
    from orb_slam3_vio_fixes_tpu_torch.ops import rectify

    by_mode, frame_s = {}, {}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "facade.yaml")
        with open(path, "w") as f:
            f.write(FACADE_YAML)
        for mode, n in FACADE_FRAMES.items():
            frames, ts, t_wc = facade_scenario(mode, synthetic)
            sync()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            slam = sysm.SLAMSystem(path, getattr(sysm.Sensor, mode))
            states = []
            per_frame = track_facade(slam, frames, states)
            counts = kernels.launch_counts()
            tr = slam.tracker
            rmse = facade_ate(mode, tr, ts, t_wc, n)
            jax_ate = JAX_FACADE_ATE_M[mode]
            bound = ATE_FACTOR * jax_ate + ATE_SLACK_M
            n_ins = tr._kf_seq
            if slam.sensor.is_monocular:
                min_k2 = mono_matcher_calls(states, n_ins)
            else:
                stereo = 0 if slam.sensor.is_rgbd else n
                min_k2 = stereo + 2 * (n - 1) + 6 * n_ins
            snap = os.path.join(d, f"{mode}.npz")
            slam.save_atlas(snap)
            slam2 = sysm.SLAMSystem(path, getattr(sysm.Sensor, mode))
            slam2.load_atlas(snap)
            bad = [f for f, x in convert.map_state_to_numpy(tr.state).items()
                   if not np.array_equal(x, convert.map_state_to_numpy(slam2.tracker.state)[f])]
            if not torch.equal(slam.loop_closer.db.hist, slam2.loop_closer.db.hist):
                bad.append("hists")
            if (slam2.n_keyframes(), slam2.n_landmarks(), slam2.tracker.kf_order) != (
                    slam.n_keyframes(), slam.n_landmarks(), tr.kf_order):
                bad.append("meta")
            log(f"[facade] {mode}: frames={n} state={slam.get_tracking_state()} "
                f"imu_ready={getattr(tr, 'imu_ready', None)} keyframes={len(tr.kf_order)} "
                f"keyframe_inserts={n_ins} ate_rmse_m={rmse!r} bound_m={bound!r} "
                f"(jax {jax_ate!r}) launches={counts} min_matcher_calls={min_k2} "
                f"snapshot_mismatching={bad} peak_device_mib="
                f"{torch.cuda.max_memory_allocated() / 2**20:.1f} "
                f"wall={time.perf_counter() - t0:.1f}s")
            log(f"[timing] {card}: facade {mode} {frame_stats(per_frame)}")
            if slam.get_tracking_state() != "OK" or slam.is_lost():
                raise RuntimeError(f"facade {mode} final state {slam.get_tracking_state()}")
            if slam.sensor.has_imu and not tr.imu_ready:
                raise RuntimeError(f"facade {mode}: the IMU never initialised")
            if not rmse <= bound:
                raise RuntimeError(f"facade {mode} ATE {rmse} m over the bound {bound} m")
            if bad:
                raise RuntimeError(f"facade {mode} snapshot round trip differs: {bad}")
            check_launches(f"facade {mode}", counts, n, min_k2)
            by_mode[mode] = counts
            frame_s[mode] = per_frame
            del slam, slam2
            if mode in ("RGBD", "MONOCULAR"):
                k1_one_image(f"facade {mode}", frames, device)

    # EuRoC's distorted pair: the port's parser, rectification maps, and the
    # remap of a rendered pair on the card against the CPU
    s = settings_io.load_settings("configs/EuRoC.yaml", sysm.Sensor.STEREO)
    s.precompute_rectification()
    frames, _, _ = facade_scenario("STEREO", synthetic)
    err = 0.0
    for img, m in ((frames[0][0], s.rect.map1), (frames[0][1], s.rect.map2)):
        x = torch.from_numpy(img.astype(np.float32))
        mp = torch.from_numpy(m)
        got = rectify.remap_bilinear(x.to(device), mp.to(device)).cpu()
        err = max(err, float((got - rectify.remap_bilinear(x, mp)).abs().max()))
    log(f"[facade] EuRoC.yaml: rectified fx={s.cam1.fx!r} bf={s.bf!r} "
        f"map shape={s.rect.map1.shape} remap_bilinear card vs cpu max_abs_err={err!r}")
    if not err <= 1e-3 or s.rect is None:
        raise RuntimeError(f"EuRoC rectification remap on the card differs: {err}")
    return by_mode, frame_s


def k1_one_image(label, frames, device) -> None:
    """K1 on the one-image (B = 1) atlases of the RGB-D and monocular frame
    builds, first and last frame."""
    from orb_slam3_vio_fixes_tpu_torch.ops import fast
    from orb_slam3_vio_fixes_tpu_torch.ops import image as image_ops

    layout = image_ops.atlas_layout(480, 752, 8, 1.2, align=35)
    for i in (0, len(frames) - 1):
        img = torch.from_numpy(frames[i][0]).to(device)[None]
        x = image_ops.build_pyramid_atlas(img, 8, 1.2, layout)
        got, ref = fast.fast_score_batch(x), fast.fast_score_plain(x)
        sync()
        n_bad = int((got != ref).sum())
        log(f"[k1] {label} frame {i}: shape={tuple(x.shape)} mismatches={n_bad} "
            f"nonzero={int((ref > 0).sum())}")
        if x.shape[0] != 1 or n_bad:
            raise RuntimeError(f"K1 disagrees with its plain twin on the {label} frame {i}")


def mono_matcher_calls(states, n_ins: int) -> int:
    """The matcher calls a monocular tracker always makes, from its states
    per frame: the two-view search on the initialising frame, two per frame
    tracked after it (motion model, local map), six per keyframe insert."""
    if "OK" not in states:
        return 1
    j = states.index("OK")
    return 1 + 2 * (len(states) - 1 - j) + 6 * n_ins


def make_mono_inertial_sequence(synthetic, n_frames: int = MI_FRAMES):
    """tests/test_e2e_mono_inertial.py's scene generator at 752x480 with
    fx 458 (`synthetic`: the port's io/synthetic.py, or the JAX package's in
    the test that measures the JAX numbers)."""
    rng = np.random.default_rng(11)
    world = synthetic.make_world(rng, n_points=700, extent=7.0, depth_range=(2.5, 9.0))
    seq = synthetic.make_stereo_inertial_sequence(
        rng, n_frames=n_frames, h=480, w=752, fx=458.0, baseline=0.2, world=world,
        imu_hz=200.0, accel_amp=0.8)
    return seq._replace(imgs_l=quantize(seq.imgs_l), imgs_r=quantize(seq.imgs_r))


def run_mono(tr, seq, states):
    """Every frame's left image through the monocular or monocular-inertial
    entry point (synchronised host seconds per frame); the tracking state
    after each frame appended to `states`."""
    per_frame = []
    for i in range(seq.imgs_l.shape[0]):
        f0 = time.perf_counter()
        if hasattr(tr, "process_mono_inertial"):
            imu = seq.imu[i - 1] if i > 0 else np.zeros((0, 7), np.float32)
            tr.process_mono_inertial(seq.imgs_l[i], seq.ts[i], imu)
        else:
            tr.process_mono(seq.imgs_l[i], seq.ts[i])
        sync()
        per_frame.append(time.perf_counter() - f0)
        states.append(tr.track_state)
    return per_frame


def mono_phase(label, tr, seq, device, card):
    """Counted run of a monocular tracker over `seq`, the two-view search's
    matcher inputs recorded; checks the state, keyframes, K1 (once per
    frame, B = 1) and K2 launches, and K1 / K2 exact on this path's inputs.
    Returns (launch counts, states)."""
    from orb_slam3_vio_fixes_tpu_torch import kernels
    from orb_slam3_vio_fixes_tpu_torch.frontend import mono_tracking
    from orb_slam3_vio_fixes_tpu_torch.ops import matching

    key = "search_for_initialization"
    record, tagged, masks = matcher_recorder({key})
    states = []
    sync()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with mock.patch.object(matching, "hamming_match", record), \
            mock.patch.object(mono_tracking, key, tagged(key, getattr(mono_tracking, key))):
        per_frame = run_mono(tr, seq, states)
    sync()
    counts = kernels.launch_counts()
    n = len(states)
    min_k2 = mono_matcher_calls(states, tr._kf_seq)
    init_at = states.index("OK") if "OK" in states else None
    log(f"[{label}] frames={n} state={tr.track_state} initialised_at_frame={init_at} "
        f"keyframes={len(tr.kf_order)} keyframe_inserts={tr._kf_seq} launches={counts} "
        f"min_matcher_calls={min_k2} peak_device_mib="
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} wall={time.perf_counter() - t0:.1f}s")
    log(f"[timing] {card}: {label} {frame_stats(per_frame)}")
    if tr.track_state != "OK" or len(tr.kf_order) < 3:
        raise RuntimeError(f"{label}: final state {tr.track_state}, "
                           f"{len(tr.kf_order)} keyframes")
    check_launches(label, counts, n, min_k2)
    frames = [(seq.imgs_l[i],) for i in range(n)]
    k1_one_image(label, frames, device)
    k2_on_masks(label, masks, (key,))
    return counts


def mono_path(seq, device, card) -> dict:
    """Phase 16: the bench scene's left images through MonocularTracker
    (K1 at B = 1, K2 in the two-view search and every matcher after it);
    the scale-aligned ATE against the JAX package's."""
    from orb_slam3_vio_fixes_tpu_torch.frontend.mono_tracking import MonocularTracker

    tr = MonocularTracker(camera_of(seq), tracker_config(seq), device=device)
    counts = mono_phase("mono", tr, seq, device, card)
    _, rmse, scale, n = mono_scores(seq.ts, seq.t_wc, tr.trajectory)
    bound = ATE_FACTOR * JAX_MONO_ATE_M + ATE_SLACK_M
    log(f"[mono] ate_rmse_m(scale-aligned)={rmse!r} horn_scale={scale!r} frames_scored={n} "
        f"bound_m={bound!r} (jax {JAX_MONO_ATE_M!r})")
    if n != seq.imgs_l.shape[0] or not rmse <= bound:
        raise RuntimeError(f"mono ATE {rmse} m over {n} frames, bound {bound} m")
    return counts


def mono_inertial_path(device, card) -> dict:
    """Phase 17: tests/test_e2e_mono_inertial.py's scene at 752x480 through
    MonoInertialTracker: the IMU initialised with a free scale, the metric
    ATE from the IMU chain's first keyframe on against the JAX package's,
    the Horn scale within MI_SCALE_TOL of 1."""
    from orb_slam3_vio_fixes_tpu_torch.frontend import inertial_tracking as it
    from orb_slam3_vio_fixes_tpu_torch.imu import preintegration as pre
    from orb_slam3_vio_fixes_tpu_torch.io import synthetic

    seq = make_mono_inertial_sequence(synthetic)
    calib = pre.ImuCalib.make(1.7e-4, 2e-3, 1.9e-5, 3e-3, seq.imu_hz, device=device)
    tr = it.MonoInertialTracker(camera_of(seq), calib,
                                tracker_config(seq, max_frames_between_kf=6),
                                it.InertialConfig(**MI_ICFG), device=device)
    counts = mono_phase("mono_inertial", tr, seq, device, card)
    metric, aligned, scale, n = mono_scores(seq.ts, seq.t_wc, tr.trajectory, tr.t_first_kf)
    bound = ATE_FACTOR * JAX_MI_ATE_M + ATE_SLACK_M
    log(f"[mono_inertial] imu_ready={tr.imu_ready} window_vi_bas={tr.n_vi_ba} "
        f"ate_rmse_m(metric, from the first keyframe)={metric!r} scale-aligned={aligned!r} "
        f"horn_scale={scale!r} frames_scored={n} bound_m={bound!r} (jax {JAX_MI_ATE_M!r})")
    if not tr.imu_ready:
        raise RuntimeError("mono_inertial: the IMU never initialised")
    if n < 10 or not metric <= bound or not abs(scale - 1.0) < MI_SCALE_TOL:
        raise RuntimeError(f"mono_inertial ATE {metric} m over {n} frames (bound {bound} m), "
                           f"scale {scale}")
    return counts


def write_euroc_layout(root, frames, ts, t0_ns: int = APP_T0_NS) -> dict:
    """The facade's stereo-inertial frames as a EuRoC mav0 directory: one
    empty file per image under its nanosecond stamp (the card's machine has
    no PIL, so the images are served from memory by the returned lookup in
    place of datasets.read_image), and the 200 Hz mav0/imu0/data.csv, whose
    samples reproduce each frame's IMU rows as the runner slices them."""
    images = {}
    stamps = [t0_ns + int(round(t * 1e9)) for t in ts]
    for cam, k in (("cam0", 0), ("cam1", 1)):
        d = os.path.join(root, "mav0", cam, "data")
        os.makedirs(d)
        for ns, fr in zip(stamps, frames):
            path = os.path.join(d, f"{ns}.png")
            open(path, "wb").close()
            images[path] = fr[k].astype(np.float32)
    os.makedirs(os.path.join(root, "mav0", "imu0"))
    lines = ["#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z"]
    for i in range(1, len(frames)):
        ns = stamps[i - 1]
        for row in frames[i][3]:
            ns += int(round(float(row[6]) * 1e9))
            lines.append(",".join([str(ns)] + [repr(float(x)) for x in (*row[3:6], *row[:3])]))
        if ns != stamps[i]:
            raise RuntimeError(f"IMU samples of frame {i} end at {ns} ns, not {stamps[i]}")
    with open(os.path.join(root, "mav0", "imu0", "data.csv"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return images


def native_runtime_check() -> None:
    """The host runtime library built from native/orbslam3_tpu_rt.cpp into
    build/native: a queue round trip, and its Hamming matchers exactly
    against their numpy twins on random 32-byte descriptors with ties."""
    from orb_slam3_vio_fixes_tpu_torch.runtime import native

    t0 = time.perf_counter()
    so = native.build()
    build_s = time.perf_counter() - t0
    if not native.native_available():
        raise RuntimeError(f"the native runtime {so} does not load")
    q = native.NativeQueue(4, 16, drop_oldest=True)
    items = [bytes([i]) * 16 for i in range(6)]
    for it in items:
        q.push(it)
    got = [q.pop(timeout_ms=100) for _ in range(4)]
    q.close()
    if q._q is None or got != items[2:]:
        raise RuntimeError("the native queue lost or reordered items")
    g = np.random.default_rng(0)
    dq = g.integers(0, 256, (512, 32), dtype=np.uint8)
    dt = g.integers(0, 256, (2048, 32), dtype=np.uint8)
    dt[1::7] = dt[0::7][:len(dt[1::7])]          # ties
    t0 = time.perf_counter()
    got = native.hamming_match(dq, dt)
    lib_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    ref = native.hamming_match_plain(dq, dt)
    plain_ms = 1e3 * (time.perf_counter() - t0)
    n_bad = sum(int((a != b).sum()) for a, b in zip(got, ref))
    n_bad += int((native.hamming_matrix(dq, dt) != native.hamming_matrix_plain(dq, dt)).sum())
    log(f"[native] {so.name} g++_seconds={build_s:.2f} queue round trip ok; "
        f"hamming_match 512x2048 host ms library={lib_ms:.3f} numpy={plain_ms:.3f} "
        f"mismatches={n_bad}")
    if n_bad:
        raise RuntimeError("the native Hamming matchers disagree with their numpy twins")


def app_path(device, card, facade_frame_s) -> dict:
    """Phase 15: the drone-VIO app through its real entry point,
    apps.main_template("euroc", "IMU_STEREO") as
    examples/stereo_inertial_vio.py calls it, on the facade's 36 IMU_STEREO
    frames written as a EuRoC directory, with MAVLink ODOMETRY on the
    loopback; launches counted, a local-map search's matcher inputs
    recorded. Checks the summary, the IMU, the TUM file and its ATE, the
    native queue, the MAVLink bytes against the tracker's final pose, and
    K1 / K2 exact on this path's inputs. Returns the launch counts."""
    import io
    import tempfile
    import types

    from orb_slam3_vio_fixes_tpu_torch import apps, kernels
    from orb_slam3_vio_fixes_tpu_torch.evaluation import ate
    from orb_slam3_vio_fixes_tpu_torch.frontend import inertial_tracking as it
    from orb_slam3_vio_fixes_tpu_torch.frontend import tracking
    from orb_slam3_vio_fixes_tpu_torch.io import datasets, synthetic
    from orb_slam3_vio_fixes_tpu_torch.ops import matching
    from orb_slam3_vio_fixes_tpu_torch.slam_map import vocabulary
    from orb_slam3_vio_fixes_tpu_torch.vio import camera_to_ned, mavlink, parse_frames

    native_runtime_check()
    mode = "IMU_STEREO"
    n = FACADE_FRAMES[mode]
    frames, ts, t_wc = facade_scenario(mode, synthetic)
    runners, links = [], []

    class Runner(apps.PipelineRunner):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            runners.append(self)

        def run(self):
            self.result = super().run()
            return self.result

    class Loopback(apps.LoopbackTransport):
        def __init__(self):
            super().__init__()
            links.append(self)

    link_s = {"publish": [], "drain": []}

    class Link(apps.MAVLinkInterface):
        """Times the producer side (NED conversion, queue) per frame and the
        drain (encoding, transport) once."""

        def publish_pose(self, *a, **k):
            t = time.perf_counter()
            super().publish_pose(*a, **k)
            link_s["publish"].append(time.perf_counter() - t)

        def drain(self):
            t = time.perf_counter()
            super().drain()
            link_s["drain"].append(time.perf_counter() - t)

    key = "vi_track_step/local_map_search"
    record, tagged, masks = matcher_recorder({key})
    with tempfile.TemporaryDirectory() as d:
        yaml_path = os.path.join(d, "app.yaml")
        with open(yaml_path, "w") as f:
            f.write(FACADE_YAML)
        cfg_path = os.path.join(d, "vio.json")
        with open(cfg_path, "w") as f:
            json.dump({"mode": "odometry"}, f)
        images = write_euroc_layout(os.path.join(d, "seq"), frames, ts)
        out = os.path.join(d, "traj.txt")
        argv = [yaml_path, os.path.join(d, "seq"), out, "--vio-config", cfg_path,
                "--vocab", os.path.join(vocabulary.ASSET_DIR, "vocab_b10d5.npz")]
        stdout = io.StringIO()
        sync()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with mock.patch.object(datasets, "read_image", images.__getitem__), \
                mock.patch.object(apps, "PipelineRunner", Runner), \
                mock.patch.object(apps, "LoopbackTransport", Loopback), \
                mock.patch.object(apps, "MAVLinkInterface", Link), \
                mock.patch.object(matching, "hamming_match", record), \
                mock.patch.object(it, "vi_track_step", tagged("vi_track_step", it.vi_track_step)), \
                mock.patch.object(tracking, "local_map_search",
                                  tagged("local_map_search", tracking.local_map_search)), \
                contextlib.redirect_stdout(stdout):
            rc = apps.main_template("euroc", mode, "drone VIO app", argv=argv)
        sync()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        summary = json.loads(stdout.getvalue())
        rows = np.loadtxt(out, ndmin=2)
        n_fields = {len(line.split()) for line in open(out) if line.strip()}
    runner, = runners
    slam, tr = runner.system, runner.system.tracker
    rmse, _, n_ate = ate.ate_rmse(ts + APP_T0_NS * 1e-9, t_wc, rows[:, 0], rows[:, 1:4])
    jax_ate = JAX_FACADE_ATE_M[mode]
    bound = ATE_FACTOR * jax_ate + ATE_SLACK_M
    n_ins = tr._kf_seq
    min_k2 = n + 2 * (n - 1) + 6 * n_ins
    msgs = parse_frames(bytes(links[0].buffer)) if len(links) == 1 else []
    R_cw, t_cw = tr.R.cpu().numpy().astype(np.float64), tr.t.cpu().numpy().astype(np.float64)
    ned = camera_to_ned(R_cw.T, -R_cw.T @ t_cw)
    last = (np.array(struct.unpack("<7f", msgs[-1]["payload"][8:36]))
            if msgs else np.full(7, np.nan))
    pose_err = float(np.abs(last - np.concatenate([ned["pos"], ned["quat"]])).max())
    st = summary["stage_times"]
    log(f"[app] main_template(euroc, IMU_STEREO): rc={rc} frames={summary['n_frames']} "
        f"state={summary['final_state']} imu_ready={tr.imu_ready} "
        f"keyframes={summary['n_keyframes']} keyframe_inserts={n_ins} "
        f"native_queue={runner.used_native_queue} trajectory_lines={len(rows)} "
        f"fields={sorted(n_fields)} ate_rmse_m={rmse!r} bound_m={bound!r} (jax {jax_ate!r}) "
        f"odometry_frames={sum(m['msgid'] == mavlink.MSG_ODOMETRY for m in msgs)} "
        f"of {len(msgs)} crc_ok={all(m['crc_ok'] for m in msgs)} "
        f"last_pose_ned_max_abs_err={pose_err!r} launches={counts} "
        f"min_matcher_calls={min_k2} peak_device_mib="
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} wall={wall:.1f}s")
    def ms_stats(x):
        x = 1e3 * np.asarray(x)
        return (f"p50={float(np.percentile(x, 50))!r} max={float(x.max())!r} "
                f"sum={float(x.sum())!r}")

    direct = facade_frame_s[mode]
    log(f"[timing] {card}: app runner fps={runner.result.fps!r} track_ms "
        f"{ms_stats(runner.times.series['track'])}; facade IMU_STEREO direct loop on "
        f"the same frames fps={len(direct) / sum(direct)!r} frame_ms "
        f"{ms_stats(direct)}; decode_ms mean={st['decode']['mean_ms']!r} "
        f"mavlink_ms per frame: publish="
        f"{1e3 * float(np.mean(link_s['publish']))!r} drain="
        f"{1e3 * sum(link_s['drain']) / max(len(msgs), 1)!r}")
    if rc != 0 or summary["n_frames"] != n or summary["final_state"] != "OK":
        raise RuntimeError(f"app run: rc={rc} summary={summary}")
    if not tr.imu_ready:
        raise RuntimeError("app run: the IMU never initialised")
    if len(rows) != n or n_fields != {8}:
        raise RuntimeError(f"app TUM file: {len(rows)} lines of {n_fields} fields")
    if n_ate != n or not rmse <= bound:
        raise RuntimeError(f"app ATE {rmse} m over {n_ate} frames, bound {bound} m")
    if not runner.used_native_queue:
        raise RuntimeError("the runner fell back from the native queue")
    if (len(msgs) != len(tr.traj) or len(msgs) != n
            or any(m["msgid"] != mavlink.MSG_ODOMETRY or not m["crc_ok"] for m in msgs)):
        raise RuntimeError(f"app MAVLink: {len(msgs)} frames for {len(tr.traj)} posed frames")
    if not pose_err <= 1e-5:
        raise RuntimeError(f"the last ODOMETRY is {pose_err} off the tracker's pose in NED")
    check_launches("app", counts, n, min_k2)
    seq = types.SimpleNamespace(imgs_l=np.stack([f[0] for f in frames]),
                                imgs_r=np.stack([f[1] for f in frames]))
    k1_on_frames("app", seq, (0, n - 1), device)
    k2_on_masks("app", masks, (key,))
    return counts


def bench_pass(seq, device, card, label, pipelined, async_kf):
    """bench.run_pass for the port: frame i + 1 uploads while frame i tracks,
    flush() at the end. Frames 1-59 are timed on the host clock, 60-69 count
    the stream syncs (torch.cuda.set_sync_debug_mode), 70-79 run under
    torch.profiler (the device's idle share). Returns (tracker, numbers)."""
    from orb_slam3_vio_fixes_tpu_torch import profile_track as pt

    tr = build_tracker(seq, device)
    tr.pipelined, tr.async_kf = pipelined, async_kf
    n = seq.imgs_l.shape[0]
    nxt = [tr._upload_pair(seq.imgs_l[0], seq.imgs_r[0])]
    per_frame = []

    def step(i):
        f0 = time.perf_counter()
        cur = nxt[0]
        tr.process_stereo(cur, None, seq.ts[i])
        if i + 1 < n:
            nxt[0] = tr._upload_pair(seq.imgs_l[i + 1], seq.imgs_r[i + 1])
        per_frame.append(time.perf_counter() - f0)

    sync()
    step(0)
    t0 = time.perf_counter()
    for i in range(1, 60):
        step(i)
    sync()
    fps = 59 / (time.perf_counter() - t0)
    syncs = pt.sync_sites(step, range(60, 70), prefix=f"[syncs] {card}: pipelined phase {label}")
    prof = pt.device_profile(step, range(70, n), top=5, by_stage=False,
                             prefix=f"[profile] {card}: pipelined phase {label} frames 70-{n - 1}")
    tr.flush()
    sync()
    ms = 1e3 * np.asarray(per_frame[1:60])
    out = {"fps": fps, "p50_ms": float(np.median(ms)), "p95_ms": float(np.percentile(ms, 95)),
           "idle_share": prof["idle_share"], "syncs_per_frame": syncs,
           "spec_dispatched": tr.spec_dispatched, "spec_reused": tr.spec_reused,
           "hit_rate": tr.spec_reused / max(tr.spec_dispatched, 1)}
    log(f"[timing] {card}: pipelined phase {label} " + " ".join(f"{k}={v!r}" for k, v in out.items())
        + " (frames 1-59, host clock; idle share over frames 70-79)")
    return tr, out


def pipelined_path(seq, device, card) -> dict:
    """Phase 18: the bench scenario through StereoTracker in sync mode,
    pipelined, and pipelined with asynchronous keyframe jobs, driven as
    bench.py drives it. Gates: pipelined equals sync bit for bit (trajectory,
    keyframe order, landmarks); async within tests/test_pipelined.py's bars;
    every pass's ATE within phase 5's bound; K1 once per frame in every pass;
    K2 exact against its plain twin on the pipelined path's densest
    motion-model mask (the device-side wide-radius retry). Returns the
    launch counts per pass."""
    from orb_slam3_vio_fixes_tpu_torch import kernels
    from orb_slam3_vio_fixes_tpu_torch.evaluation import ate
    from orb_slam3_vio_fixes_tpu_torch.frontend import tracking
    from orb_slam3_vio_fixes_tpu_torch.frontend.tracking import TrackState
    from orb_slam3_vio_fixes_tpu_torch.ops import matching

    ate_bound = ATE_FACTOR * JAX_ATE_M + ATE_SLACK_M
    runs, counts = {}, {}
    for label, pipelined, async_kf in PIPELINE_MODES:
        kernels.reset_launch_counts()
        tr, numbers = bench_pass(seq, device, card, label, pipelined, async_kf)
        counts[label] = kernels.launch_counts()
        traj = tr.trajectory
        C = np.array([-R.T @ t for _, R, t in traj])
        if not np.all(np.isfinite(C)) or C.shape != (N_FRAMES, 3):
            raise RuntimeError(f"pipelined phase {label}: bad trajectory {C.shape}")
        rmse, _, n = ate.ate_rmse(seq.ts, seq.t_wc, np.array([x[0] for x in traj]), C)
        runs[label] = (tr, traj, C)
        log(f"[pipelined] {label}: state={tr.track_state} keyframes={len(tr.kf_order)} "
            f"landmarks={tr.n_lm} ate_rmse_m={rmse!r} bound_m={ate_bound!r} "
            f"launches={counts[label]}")
        if tr.track_state != TrackState.OK or n != N_FRAMES or not rmse <= ate_bound:
            raise RuntimeError(f"pipelined phase {label}: state {tr.track_state}, ATE {rmse} m "
                               f"(bound {ate_bound} m)")
        if counts[label]["fast_score"] != N_FRAMES:
            raise RuntimeError(f"pipelined phase {label}: K1 launched "
                               f"{counts[label]['fast_score']} times for {N_FRAMES} frames")
    (s_tr, s_traj, s_C), (p_tr, p_traj, _), (a_tr, _, a_C) = (
        runs[label] for label, _, _ in PIPELINE_MODES)
    same = (p_tr.kf_order == s_tr.kf_order and p_tr.n_lm == s_tr.n_lm
            and all(np.array_equal(x[1], y[1]) and np.array_equal(x[2], y[2])
                    for x, y in zip(s_traj, p_traj)))
    err = np.linalg.norm(a_C - s_C, axis=1)
    log(f"[pipelined] pipelined equals sync bit for bit: {same}; async against sync: "
        f"same keyframe order {a_tr.kf_order == s_tr.kf_order}, landmarks {a_tr.n_lm} vs "
        f"{s_tr.n_lm}, centre error median {float(np.median(err))!r} max {float(err.max())!r} m")
    if not same:
        raise RuntimeError("the pipelined trajectory differs from sync mode's")
    if (a_tr.kf_order != s_tr.kf_order
            or abs(a_tr.n_lm - s_tr.n_lm) > ASYNC_LM_FRAC * s_tr.n_lm
            or not np.median(err) < ASYNC_MEDIAN_M or not err.max() < ASYNC_MAX_M):
        raise RuntimeError("async keyframe jobs outside the bars against sync mode")
    # the pipelined path's K2 input: its densest motion-model search mask
    record, tagged, masks = matcher_recorder({"match_previous"}, densest=True)
    tr = build_tracker(seq, device)
    tr.pipelined = True
    with mock.patch.object(matching, "hamming_match", record), \
            mock.patch.object(tracking, "match_previous",
                              tagged("match_previous", tracking.match_previous)):
        for i in range(6):
            tr.process_stereo(seq.imgs_l[i], seq.imgs_r[i], seq.ts[i])
        tr.flush()
    sync()
    dq, dt, mask, _ = masks["match_previous"]
    log(f"[k2] pipelined path mask match_previous (densest): shape={tuple(mask.shape)} "
        f"density={float(mask.float().mean())!r}")
    _k2_compare("pipelined match_previous", dq, dt, mask)
    return counts


def fisheye_settings():
    from orb_slam3_vio_fixes_tpu_torch.io import settings
    from orb_slam3_vio_fixes_tpu_torch.sensors import Sensor

    return settings.load_settings(FISHEYE_CONFIG, Sensor.IMU_STEREO)


def fisheye_scenario(n_frames: int = FISHEYE_FRAMES):
    """(frames, ts, t_wc, depth0) of phase 19: bench.py's stereo-inertial
    trajectory (seed 11) as camera 1's, each camera rendered through its
    KannalaBrandt8 model from configs/TUM-VI.yaml at 512x512 (camera 2 at
    T_c1_c2), the IMU samples moved to TUM-VI's body frame (T_b_c1, with the
    lever arm of the constant yaw rate) plus the yaml's white noise at its
    rate; depth0 is frame 0's left z-buffer. Each frame is (left, right,
    timestamp, IMU samples since the previous frame)."""
    from orb_slam3_vio_fixes_tpu_torch.io import synthetic
    from orb_slam3_vio_fixes_tpu_torch.utils.cameras import project

    st = fisheye_settings()
    h, w = st.height, st.width
    rng = np.random.default_rng(11)
    # a room-scale world, as tests/test_fisheye_stereo.py's: with a 0.10 m
    # baseline the parallax gate (cos < 0.9998) keeps depths below ~5 m
    world = synthetic.make_world(rng, n_points=FISHEYE_POINTS, extent=4.0,
                                 depth_range=(2.0, 7.0))
    # the trajectory and its camera-frame IMU (tiny images: they are not used)
    s = synthetic.make_stereo_inertial_sequence(rng, n_frames=n_frames, h=8, w=8,
                                                fx=st.cam1.fx, baseline=0.11, world=world,
                                                imu_hz=st.imu_freq, accel_amp=0.6)
    R_bc, t_bc = st.T_bc[:3, :3], st.T_bc[:3, 3]
    r_c = -R_bc.T @ t_bc                       # the body origin in camera 1's frame
    acc, gyro = s.imu[..., :3].astype(np.float64), s.imu[..., 3:6].astype(np.float64)
    acc = acc + np.cross(gyro, np.cross(gyro, r_c))
    noise = np.random.default_rng(12)
    rate = np.sqrt(st.imu_freq)
    imu = s.imu.copy()
    imu[..., :3] = acc @ R_bc.T + noise.normal(0, st.noise_acc * rate, acc.shape)
    imu[..., 3:6] = gyro @ R_bc.T + noise.normal(0, st.noise_gyro * rate, gyro.shape)
    R_12, t_12 = st.T_c1_c2[:3, :3], st.T_c1_c2[:3, 3]

    def view(cam, R_wc, C):
        K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]], np.float32)
        R_cw = R_wc.T.astype(np.float32)
        return K, R_cw, (-R_cw @ C).astype(np.float32), lambda Xc: project(
            cam, torch.as_tensor(Xc, dtype=torch.float32)).numpy()

    frames, depth0 = [], None
    for i in range(n_frames):
        K1, R1, t1, p1 = view(st.cam1, s.R_wc[i], s.t_wc[i])
        K2, R2, t2, p2 = view(st.cam2, s.R_wc[i] @ R_12, s.t_wc[i] + s.R_wc[i] @ t_12)
        left = synthetic.render(world, K1, R1, t1, h, w, return_depth=i == 0, project_fn=p1)
        if i == 0:
            left, depth0 = left
        right = synthetic.render(world, K2, R2, t2, h, w, project_fn=p2)
        frames.append((quantize(left), quantize(right), s.ts[i],
                       imu[i - 1] if i > 0 else np.zeros((0, 7), np.float32)))
    return frames, s.ts, s.t_wc, depth0


def fisheye_frame0(frames, device):
    """Frame 0 through the port's two-camera build with TUM-VI.yaml's rig."""
    from orb_slam3_vio_fixes_tpu_torch.frontend import frame as frame_mod
    from orb_slam3_vio_fixes_tpu_torch.ops import orb

    st = fisheye_settings()
    T = torch.as_tensor(np.asarray(st.T_c1_c2, np.float32), device=device)
    return frame_mod.build_fisheye_stereo_frame(
        torch.as_tensor(frames[0][0], device=device), torch.as_tensor(frames[0][1], device=device),
        torch.zeros((), device=device), st.cam1, st.cam2, T[:3, :3], T[:3, 3],
        orb.ORBConfig(st.n_features, st.n_levels, st.scale_factor))


def fisheye_frame_check(frames, depth0, device) -> None:
    """Frame 0 through the port's two-camera build on the card: at least
    FISHEYE_MIN_DEPTHS triangulated keypoints whose median relative depth
    error against the z-buffer is below FISHEYE_DEPTH_REL."""
    f = fisheye_frame0(frames, device)
    depth, uv, valid = (x.cpu().numpy() for x in (f.depth, f.uv, f.valid))
    has = valid & (depth > 0)
    xi = np.clip(np.round(uv[:, 0]).astype(int), 0, depth0.shape[1] - 1)
    yi = np.clip(np.round(uv[:, 1]).astype(int), 0, depth0.shape[0] - 1)
    z = depth0[yi, xi]
    ok = has & (z > 0)
    rel = np.abs(depth[ok] - z[ok]) / z[ok]
    med = float(np.median(rel)) if ok.any() else float("inf")
    log(f"[fisheye] frame 0: triangulated={int(has.sum())} median_rel_depth_err={med!r} "
        f"within_30pct={float((rel < 0.3).mean()) if ok.any() else 0.0!r}")
    if has.sum() < FISHEYE_MIN_DEPTHS or not med < FISHEYE_DEPTH_REL:
        raise RuntimeError(f"fisheye frame build: {int(has.sum())} depths, median relative "
                           f"error {med}")


def fisheye_path(device, card) -> dict:
    """Phase 19: SLAMSystem from configs/TUM-VI.yaml (a KannalaBrandt8 rig,
    tracked unrectified) in IMU_STEREO and STEREO on the fisheye scenario.
    Gates: the frame-0 build check; per mode the final state OK, the ATE
    within ATE_FACTOR x the JAX package's + ATE_SLACK_M, K1 once per frame
    (B = 2 at 512x512) and K2 at least once per matcher call; K1 exact on
    frame 0's atlas and K2 on frame 0's brute-force left-right mask.
    Returns the launch counts per mode."""
    from orb_slam3_vio_fixes_tpu_torch import kernels
    from orb_slam3_vio_fixes_tpu_torch import system as sysm
    from orb_slam3_vio_fixes_tpu_torch.ops import fast, matching
    from orb_slam3_vio_fixes_tpu_torch.ops import image as image_ops

    t0 = time.perf_counter()
    frames, ts, t_wc, depth0 = fisheye_scenario()
    log(f"[fisheye] {len(frames)} frames rendered at 512x512 in "
        f"{time.perf_counter() - t0:.1f}s")
    fisheye_frame_check(frames, depth0, device)
    st = fisheye_settings()
    counts = {}
    for mode in FISHEYE_MODES:
        slam = sysm.SLAMSystem(FISHEYE_CONFIG, getattr(sysm.Sensor, mode), device=device)
        states = []
        kernels.reset_launch_counts()
        per_frame = track_facade(slam, frames, states)
        counts[mode] = kernels.launch_counts()
        tr = slam.tracker
        rmse = trajectory_ate(ts, t_wc, tr, len(frames))
        jax_ate = JAX_FISHEYE_ATE_M[mode]
        bound_m = ATE_FACTOR * jax_ate + ATE_SLACK_M
        n_ins = tr._kf_seq
        min_calls = len(frames) + 2 * (len(frames) - 1) + 6 * n_ins
        log(f"[fisheye] {mode}: state={tr.track_state} states_ok="
            f"{sum(x == 'OK' for x in states)}/{len(states)} imu_ready="
            f"{getattr(tr, 'imu_ready', None)} keyframes={len(tr.kf_order)} "
            f"keyframe_inserts={n_ins} landmarks={tr.n_lm} ate_rmse_m={rmse!r} "
            f"bound_m={bound_m!r} (jax {jax_ate!r}) launches={counts[mode]} "
            f"min_matcher_calls={min_calls}")
        log(f"[timing] {card}: fisheye {mode} {frame_stats(per_frame)}")
        if tr.track_state != "OK" or not rmse <= bound_m:
            raise RuntimeError(f"fisheye {mode}: state {tr.track_state}, ATE {rmse} m "
                               f"(bound {bound_m} m)")
        if counts[mode]["fast_score"] != len(frames) or counts[mode]["hamming_match"] < min_calls:
            raise RuntimeError(f"fisheye {mode}: launches {counts[mode]} for {len(frames)} "
                               f"frames, at least {min_calls} matcher calls")
    # K1 at B = 2 on frame 0's 512x512 atlas; K2 on its brute-force mask
    layout = image_ops.atlas_layout(st.height, st.width, st.n_levels, st.scale_factor,
                                    align=35)
    imgs = torch.as_tensor(np.stack(frames[0][:2]), device=device)
    x = image_ops.build_pyramid_atlas(imgs, st.n_levels, st.scale_factor, layout)
    got, ref = fast.fast_score_batch(x), fast.fast_score_plain(x)
    sync()
    n_bad = int((got != ref).sum())
    log(f"[k1] fisheye frame 0 atlas {tuple(x.shape)}: mismatches={n_bad}")
    if n_bad:
        raise RuntimeError("K1 disagrees with its plain twin on the fisheye atlas")
    record, tagged, masks = matcher_recorder({"fisheye"})
    with mock.patch.object(matching, "hamming_match", record), \
            mock.patch.object(matching, "match_descriptors",
                              tagged("fisheye", matching.match_descriptors)):
        fisheye_frame0(frames, device)
    dq, dt, mask, _ = masks["fisheye"]
    log(f"[k2] fisheye brute-force mask: shape={tuple(mask.shape)} "
        f"density={float(mask.float().mean())!r}")
    _k2_compare("fisheye brute force", dq, dt, mask)
    return counts


# Phases 7-19 run in worker processes, each its phases in this order, all at
# once on the one card: every phase is host-bound (the device sits idle 0.91-
# 0.94 of a frame, PERF.md section 5), so one process leaves 7 of the
# machine's 8 cores and most of the card unused, and the phases one after the
# other ran 1147-1450 s. Each worker is a fresh process, as the driver's and
# phase_repeat's runs are. The kernel timings (phase 6) run after every
# worker has ended, on a card that runs nothing else.
WORKERS = (("si_loop",),
           ("si_atlas", "mono_inertial", "mesh"),
           ("facade", "app"),
           ("pipelined", "fisheye"),
           ("stereo_inertial", "loop", "relocalization", "atlas", "mono"))


def run_phases(names, card, report) -> None:
    """Run the named phases in this process, each followed by a synchronise;
    report(by_path, seconds) after each. by_path maps a path name to its K1 /
    K2 launch counts (phases with several passes or modes give one entry
    each)."""
    device = torch.device("cuda")
    made = {}

    def get(key, make):
        if key not in made:
            made[key] = make()
        return made[key]

    def vocab():
        from orb_slam3_vio_fixes_tpu_torch.slam_map import vocabulary

        def load():
            v = vocabulary.default_vocabulary(device)
            log(f"[vocab] {vocabulary.ASSET_DIR}/vocab_b10d5.npz words={v.n_words} "
                f"nodes={tuple(v.nodes.shape)}")
            return v
        return get("vocab", load)

    seq = lambda: get("seq", make_sequence)          # noqa: E731
    facade = {}

    def run_facade():
        counts, facade["frame_s"] = facade_path(device, card)
        return {f"facade_{mode.lower()}": c for mode, c in counts.items()}

    def per_pass(name, out):
        return {f"{name}_{label.lower()}": c for label, c in out.items()}

    phases = {
        "stereo_inertial": lambda: {"stereo_inertial": inertial_path(
            make_inertial_sequence(), device, card)},
        "loop": lambda: {"loop": loop_path(make_loop_sequence(), vocab(), device, card)},
        "relocalization": lambda: {"relocalization": reloc_path(vocab(), device, card)},
        "atlas": lambda: {"atlas": atlas_path(vocab(), device, card)},
        "si_loop": lambda: {"si_loop": si_loop_path(vocab(), device, card)},
        "si_atlas": lambda: {"si_atlas": si_atlas_path(vocab(), device, card)},
        "facade": run_facade,
        "app": lambda: {"app": app_path(device, card, facade["frame_s"])},
        "mono": lambda: {"mono": mono_path(seq(), device, card)},
        "mono_inertial": lambda: {"mono_inertial": mono_inertial_path(device, card)},
        "pipelined": lambda: per_pass("pipelined", pipelined_path(seq(), device, card)),
        "fisheye": lambda: per_pass("fisheye", fisheye_path(device, card)),
        "mesh": lambda: mesh_path(vocab(), device, card),
    }
    for name in names:
        t = time.perf_counter()
        by_path = phases[name]()
        sync()
        seconds = round(time.perf_counter() - t, 1)
        log(f"[phase] {name} seconds={seconds}")
        report(by_path, {name: seconds})


def worker(names, card, results) -> None:
    """A worker process's body: the named phases; each one's launch counts
    and seconds go to the `results` queue. An exception ends the process
    with a non-zero code."""
    from orb_slam3_vio_fixes_tpu_torch import kernels
    from orb_slam3_vio_fixes_tpu_torch.utils import determinism

    determinism.enable()            # before any CUDA work
    kernels.library()               # built by the parent
    run_phases(names, card, lambda by_path, seconds: results.put((by_path, seconds)))
    results.put(None)


def run_workers(card, main_work):
    """Start one process per WORKERS entry, run main_work() here meanwhile,
    then collect the workers' counts and seconds. Fails (after stopping
    every worker) if one exits non-zero or without its results."""
    import multiprocessing as mp
    import queue

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=worker, args=(names, card, results))
             for names in WORKERS]
    by_path, phase_s = {}, {}
    try:
        for p in procs:
            p.start()
        main_work()
        finished = 0
        while finished < len(procs):
            try:
                got = results.get(timeout=10)
            except queue.Empty:
                # a worker that ended on an exception (its traceback is on
                # stderr), or was killed, reports nothing more
                failed = [(names, p.exitcode) for names, p in zip(WORKERS, procs)
                          if p.exitcode not in (None, 0)]
                if failed:
                    raise RuntimeError(f"worker processes failed (phases, exit code): {failed}")
                if all(p.exitcode == 0 for p in procs):
                    raise RuntimeError("a worker ended without reporting its end")
                continue
            if got is None:
                finished += 1
            else:
                by_path.update(got[0])
                phase_s.update(got[1])
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join()
    return by_path, phase_s


def main() -> int:
    t_start = time.perf_counter()
    card = card_facts()
    from orb_slam3_vio_fixes_tpu_torch.utils import determinism

    determinism.enable()            # before any CUDA work
    device = torch.device("cuda")
    log(f"[card] {card}")

    from orb_slam3_vio_fixes_tpu_torch import kernels

    t0 = time.perf_counter()
    so, nvcc_s = kernels.build()
    kernels.library()
    sync()
    log(f"[build] {so.name} nvcc_seconds={nvcc_s:.2f} total={time.perf_counter() - t0:.2f}s")

    here = {}

    def main_work():
        seq = make_sequence()
        k1 = check_k1(seq, device)
        sync()
        path_masks = capture_path_masks(seq, device)
        k2 = check_k2(device, path_masks)
        sync()
        log(f"[k1] {k1}  [k2] {k2}")
        t = time.perf_counter()
        counts = main_path(seq, device, card)
        sync()
        here.update(seq=seq, path_masks=path_masks, k1=k1, k2=k2, counts=counts,
                    seconds=round(time.perf_counter() - t, 1))
        log(f"[phase] stereo seconds={here['seconds']}")

    t0 = time.perf_counter()
    workers_by_path, workers_s = run_workers(card, main_work)
    log(f"[phase] phases 5, 7-19 (in {len(WORKERS) + 1} processes) "
        f"seconds={time.perf_counter() - t0:.1f}")
    # phase 6 on a card that runs nothing else
    times = path_kernel_times(here["seq"], device, here["path_masks"], card)
    sync()
    by_path = {"stereo": here["counts"], **workers_by_path}
    phase_s = {"stereo": here["seconds"], **workers_s}
    log(f"[phase] seconds={phase_s}")
    log(f"[script] seconds={time.perf_counter() - t_start:.1f}")
    counts = by_path["stereo"]

    def numbers(label):
        k_ms, _, p_ms, b_ms, b_by = times[label]
        return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None}

    src = "orb_slam3_vio_fixes_tpu_torch/csrc/"
    report = {"kernels": [
        {"name": "fast_score", "route": "cuda", "source": src + "fast_score.cu",
         "replaces": "orb_slam3_vio_fixes_tpu/ops/pallas_kernels.py:63",
         "launches": counts["fast_score"], **here["k1"],
         "launches_by_path": {k: c["fast_score"] for k, c in by_path.items()},
         **numbers("fast_score 2x2380x752")},
        {"name": "hamming_match", "route": "cuda", "source": src + "hamming.cu",
         "replaces": "orb_slam3_vio_fixes_tpu/ops/matching.py:39",
         "launches": counts["hamming_match"], **here["k2"],
         "launches_by_path": {k: c["hamming_match"] for k, c in by_path.items()},
         **numbers("hamming_match 1024x1024 cols")},
    ]}
    print(json.dumps(report))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
