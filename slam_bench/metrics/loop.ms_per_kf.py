"""loop.ms_per_kf: Synchronised host milliseconds of loop closing per keyframe
inserted: StereoTracker._kf_stage_loop, i.e. LoopCloser.on_keyframe (BoW
query, verification, pose graph and global BA on a correction) with the
seam fuse, the welding BA and the post-loop hook."""

NAME = "loop.ms_per_kf"
UNIT = "ms"
LAYER = "loop closing"
MOVES = "tracked_fps"
TRACKING = "orb_slam3_vio_fixes_tpu_torch.frontend.tracking"
SPANS = [(TRACKING, "kf_create_map", "kf_create_map"),
         (TRACKING, "StereoTracker._kf_stage_loop", "kf_stage_loop")]


def read(t: dict):
    n = len(t["spans"].get("kf_create_map", ()))
    ts = t["spans"].get("kf_stage_loop")
    return 1e3 * sum(ts) / n if n and ts else None
