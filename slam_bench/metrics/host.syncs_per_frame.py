"""host.syncs_per_frame: Stream synchronisations per frame inside
SLAMSystem.track_stereo (the host state machines of frontend/tracking.py
and frontend/inertial_tracking.py waiting on the device), counted by
torch.cuda's sync debug mode over the traced run's sync stretch."""

NAME = "host.syncs_per_frame"
UNIT = "syncs/frame"
LAYER = "tracker host state machine"
MOVES = "tracked_fps"
SPANS = []


def read(t: dict):
    s = t.get("syncs")
    return s["count"] / s["frames"] if s and s["frames"] else None
