"""vi_local_ba.ms: Mean synchronised host milliseconds per call of the
inertial window BA (frontend/inertial_tracking.inertial_local_ba over
optim/vi_ba.py)."""

NAME = "vi_local_ba.ms"
UNIT = "ms"
LAYER = "inertial window BA"
MOVES = "tracked_fps"
INERTIAL = "orb_slam3_vio_fixes_tpu_torch.frontend.inertial_tracking"
SPANS = [(INERTIAL, "inertial_local_ba", "vi_local_ba")]


def read(t: dict):
    ts = t["spans"].get("vi_local_ba")
    return 1e3 * sum(ts) / len(ts) if ts else None
