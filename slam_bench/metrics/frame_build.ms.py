"""frame_build.ms: Mean synchronised host milliseconds per call of the stereo
frame build (frontend/frame.build_stereo_frame_impl: pyramid, K1, ORB,
stereo K2 and SAD refinement)."""

NAME = "frame_build.ms"
UNIT = "ms"
LAYER = "frame build"
MOVES = "tracked_fps"
TRACKING = "orb_slam3_vio_fixes_tpu_torch.frontend.tracking"
SPANS = [(TRACKING, "build_stereo_frame_impl", "frame_build")]


def read(t: dict):
    ts = t["spans"].get("frame_build")
    return 1e3 * sum(ts) / len(ts) if ts else None
