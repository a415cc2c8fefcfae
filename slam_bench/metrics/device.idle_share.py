"""device.idle_share: Share of the traced run's profile stretch (frames with
keyframes in it) in which no kernel, copy or memset ran on the card: 1 -
busy / wall."""

NAME = "device.idle_share"
UNIT = "%"
LAYER = "device"
MOVES = "tracked_fps"
SPANS = []


def read(t: dict):
    p = t.get("profile")
    return 100.0 * (1.0 - p["busy_s"] / p["wall_s"]) if p and p["wall_s"] > 0 else None
