"""The port runs where JAX is absent: it imports with `jax` blocked, and no
source of the package (nor chip_smoke.py) imports jax or the JAX package."""

import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "orb_slam3_vio_fixes_tpu_torch"

FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+orb_slam3_vio_fixes_tpu\b|"
    r"from\s+orb_slam3_vio_fixes_tpu(\.|\s)|.*\borb_slam3_vio_fixes_tpu\.)",
    re.MULTILINE)


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['orb_slam3_vio_fixes_tpu'] = None\n"
        "import orb_slam3_vio_fixes_tpu_torch\n"
        "from orb_slam3_vio_fixes_tpu_torch import convert, kernels\n"
        "from orb_slam3_vio_fixes_tpu_torch.frontend.tracking import StereoTracker\n"
        "from orb_slam3_vio_fixes_tpu_torch.frontend.inertial_tracking import (\n"
        "    StereoInertialTracker)\n"
        "from orb_slam3_vio_fixes_tpu_torch.imu import preintegration\n"
        "from orb_slam3_vio_fixes_tpu_torch.optim import inertial_init, vi_ba, vi_global_ba\n"
        "from orb_slam3_vio_fixes_tpu_torch.utils import autodiff\n"
        "from orb_slam3_vio_fixes_tpu_torch import profile_track\n"
        "from orb_slam3_vio_fixes_tpu_torch.io import synthetic\n"
        "from orb_slam3_vio_fixes_tpu_torch.evaluation import ate\n"
        "import chip_smoke\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_no_jax_import_in_port_sources():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    bad = [(str(f.relative_to(ROOT)), m.group(0).strip())
           for f in files for m in FORBIDDEN.finditer(f.read_text())]
    assert not bad, bad
