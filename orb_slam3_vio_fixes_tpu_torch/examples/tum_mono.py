"""Monocular TUM (Examples/Monocular/mono_tum.cc analogue)."""
import sys

from orb_slam3_vio_fixes_tpu_torch.apps import main_template

if __name__ == "__main__":
    sys.exit(main_template("tum_rgbd", "MONOCULAR", __doc__))
