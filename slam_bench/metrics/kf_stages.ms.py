"""kf_stages.ms: Synchronised host milliseconds of the keyframe stages per
keyframe inserted: frontend/tracking.kf_create_map + kf_ba_stage (local BA)
+ StereoTracker._kf_stage_cull."""

NAME = "kf_stages.ms"
UNIT = "ms"
LAYER = "keyframe stages"
MOVES = "frame_ms_p95"
TRACKING = "orb_slam3_vio_fixes_tpu_torch.frontend.tracking"
SPANS = [(TRACKING, "kf_create_map", "kf_create_map"),
         (TRACKING, "kf_ba_stage", "kf_ba_stage"),
         (TRACKING, "StereoTracker._kf_stage_cull", "kf_cull")]


def read(t: dict):
    n = len(t["spans"].get("kf_create_map", ()))
    if not n:
        return None
    return 1e3 * sum(sum(t["spans"].get(k, ())) for k in ("kf_create_map", "kf_ba_stage",
                                                          "kf_cull")) / n
