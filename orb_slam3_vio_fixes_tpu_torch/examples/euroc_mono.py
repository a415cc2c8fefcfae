"""Monocular EuRoC (Examples/Monocular/mono_euroc.cc analogue)."""
import sys

from orb_slam3_vio_fixes_tpu_torch.apps import main_template

if __name__ == "__main__":
    sys.exit(main_template("euroc", "MONOCULAR", __doc__))
