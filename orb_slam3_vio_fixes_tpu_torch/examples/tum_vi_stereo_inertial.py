"""Stereo-inertial TUM-VI fisheye (Examples/Stereo-Inertial/stereo_inertial_tum_vi.cc analogue)."""
import sys

from orb_slam3_vio_fixes_tpu_torch.apps import main_template

if __name__ == "__main__":
    sys.exit(main_template("tumvi", "IMU_STEREO", __doc__))
