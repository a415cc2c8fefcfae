"""The port runs where JAX is absent: it imports with `jax` blocked, and no
source of the package (nor chip_smoke.py) imports jax or the JAX package;
the multi-device layer (`parallel`, `dryrun`), the lifetime runs
(`lifetime`), the single-image, noise-model and ground-truth entries and
the tools (`scripts`) included.
The card's machine has no PyYAML, PIL or matplotlib either: the port imports
with all three blocked, and no source imports yaml (the dataset loaders and
the viewer import PIL and matplotlib inside the functions that read or
write image files, which chip_smoke.py never calls).

This module also loads the test suite's plugin that frees JAX's compiled
executables at every module boundary (tests/torch_jax_release.py): every
worker collects this module, so the hook is live in every worker."""

import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "orb_slam3_vio_fixes_tpu_torch"

pytest_plugins = ["torch_jax_release"]

FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+orb_slam3_vio_fixes_tpu\b|"
    r"from\s+orb_slam3_vio_fixes_tpu(\.|\s)|.*\borb_slam3_vio_fixes_tpu\.|"
    r"import\s+yaml\b|from\s+yaml\b)",
    re.MULTILINE)


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['orb_slam3_vio_fixes_tpu'] = None\n"
        "sys.modules['yaml'] = None\n"
        "sys.modules['PIL'] = None\n"
        "sys.modules['matplotlib'] = None\n"
        "import orb_slam3_vio_fixes_tpu_torch\n"
        "from orb_slam3_vio_fixes_tpu_torch import convert, kernels\n"
        "from orb_slam3_vio_fixes_tpu_torch.frontend.tracking import StereoTracker\n"
        "from orb_slam3_vio_fixes_tpu_torch.frontend.inertial_tracking import (\n"
        "    StereoInertialTracker)\n"
        "from orb_slam3_vio_fixes_tpu_torch.imu import preintegration\n"
        "from orb_slam3_vio_fixes_tpu_torch.optim import inertial_init, vi_ba, vi_global_ba\n"
        "from orb_slam3_vio_fixes_tpu_torch.utils import autodiff\n"
        "from orb_slam3_vio_fixes_tpu_torch import gravity_spread, phase_repeat, profile_track\n"
        "from orb_slam3_vio_fixes_tpu_torch.io import synthetic\n"
        "from orb_slam3_vio_fixes_tpu_torch.evaluation import ate\n"
        "from orb_slam3_vio_fixes_tpu_torch.frontend import loop_closing, relocalization\n"
        "from orb_slam3_vio_fixes_tpu_torch.ops import pnp, sim3\n"
        "from orb_slam3_vio_fixes_tpu_torch.optim import global_ba, pose_graph\n"
        "from orb_slam3_vio_fixes_tpu_torch.slam_map import atlas, snapshot, vocabulary\n"
        "assert vocabulary.default_vocabulary('cpu').n_words == 100000\n"
        "from orb_slam3_vio_fixes_tpu_torch import sensors, system\n"
        "from orb_slam3_vio_fixes_tpu_torch.io import datasets, settings, trajectory\n"
        "from orb_slam3_vio_fixes_tpu_torch.ops import rectify\n"
        "assert system.Sensor is sensors.Sensor\n"
        "s = settings.load_settings('configs/EuRoC.yaml', sensors.Sensor.IMU_STEREO)\n"
        "assert s.T_bc.shape == (4, 4) and s.dist1 is not None\n"
        "from orb_slam3_vio_fixes_tpu_torch import apps, runtime, vio, viz\n"
        "from orb_slam3_vio_fixes_tpu_torch.runtime import actors, native\n"
        "from orb_slam3_vio_fixes_tpu_torch.vio import frames, interface, mavlink, uart\n"
        "from orb_slam3_vio_fixes_tpu_torch.viz import frame_drawer, map_drawer, viewer\n"
        "from orb_slam3_vio_fixes_tpu_torch.examples import (\n"
        "    euroc_multisession, euroc_stereo, euroc_stereo_inertial, kitti_stereo,\n"
        "    stereo_inertial_vio, tum_rgbd)\n"
        "from orb_slam3_vio_fixes_tpu_torch.examples import euroc_mono, tum_mono, tum_vi_stereo_inertial\n"
        "from orb_slam3_vio_fixes_tpu_torch.frontend.mono_tracking import MonocularTracker\n"
        "from orb_slam3_vio_fixes_tpu_torch.frontend.inertial_tracking import (\n"
        "    MonoInertialTracker)\n"
        "from orb_slam3_vio_fixes_tpu_torch.frontend.frame import build_mono_frame\n"
        "from orb_slam3_vio_fixes_tpu_torch.ops import twoview\n"
        "from orb_slam3_vio_fixes_tpu_torch.utils import determinism\n"
        "assert apps.PipelineRunner is runtime.PipelineRunner\n"
        "from orb_slam3_vio_fixes_tpu_torch import dryrun, parallel\n"
        "from orb_slam3_vio_fixes_tpu_torch.parallel import mesh, sharded_ba, sharded_matching\n"
        "assert parallel.Mesh is mesh.Mesh\n"
        "from orb_slam3_vio_fixes_tpu_torch import lifetime\n"
        "from orb_slam3_vio_fixes_tpu_torch.ops.fast import detect, fast_score\n"
        "from orb_slam3_vio_fixes_tpu_torch.ops.orb import extract\n"
        "from orb_slam3_vio_fixes_tpu_torch.slam_map.vocabulary import save\n"
        "from orb_slam3_vio_fixes_tpu_torch.io.synthetic import (\n"
        "    DEFAULT_NOISE, SensorNoise, degrade_images, degrade_stereo, perturb_imu,\n"
        "    load_gt_trajectory, make_gt_stereo_inertial_sequence, make_gt_stereo_sequence,\n"
        "    make_world_along_trajectory)\n"
        "from orb_slam3_vio_fixes_tpu_torch.scripts import (\n"
        "    bench_scaling, evaluate_ate, train_default_vocab, train_vocab_large,\n"
        "    train_vocabulary)\n"
        "import chip_smoke\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_no_jax_import_in_port_sources():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    names = {str(f.relative_to(PKG)) for f in files if f.is_relative_to(PKG)}
    assert {"dryrun.py", "parallel/__init__.py", "parallel/mesh.py",
            "parallel/sharded_ba.py", "parallel/sharded_matching.py", "lifetime.py",
            "scripts/__init__.py", "scripts/bench_scaling.py", "scripts/evaluate_ate.py",
            "scripts/train_default_vocab.py", "scripts/train_vocab_large.py",
            "scripts/train_vocabulary.py"} <= names
    bad = [(str(f.relative_to(ROOT)), m.group(0).strip())
           for f in files for m in FORBIDDEN.finditer(f.read_text())]
    assert not bad, bad
