"""track_step.ms: Mean synchronised host milliseconds per call of the visual
tracking step (frontend/tracking.track_step_impl: motion model, local-map
search, pose optimisation)."""

NAME = "track_step.ms"
UNIT = "ms"
LAYER = "visual tracking step"
MOVES = "tracked_fps"
TRACKING = "orb_slam3_vio_fixes_tpu_torch.frontend.tracking"
SPANS = [(TRACKING, "track_step_impl", "track_step")]


def read(t: dict):
    ts = t["spans"].get("track_step")
    return 1e3 * sum(ts) / len(ts) if ts else None
