"""vi_track_step.ms: Mean synchronised host milliseconds per call of the
visual-inertial tracking step (frontend/inertial_tracking.vi_track_step)."""

NAME = "vi_track_step.ms"
UNIT = "ms"
LAYER = "VI tracking step"
MOVES = "tracked_fps"
INERTIAL = "orb_slam3_vio_fixes_tpu_torch.frontend.inertial_tracking"
SPANS = [(INERTIAL, "vi_track_step", "vi_track_step")]


def read(t: dict):
    ts = t["spans"].get("vi_track_step")
    return 1e3 * sum(ts) / len(ts) if ts else None
