"""device.launches_per_frame: Device ops (kernels, copies, memsets) per frame
over the traced run's profile stretch."""

NAME = "device.launches_per_frame"
UNIT = "launches/frame"
LAYER = "device"
MOVES = "tracked_fps"
SPANS = []


def read(t: dict):
    p = t.get("profile")
    return p["launches"] / p["frames"] if p and p["frames"] else None
