"""k1_roofline: Kernel K1's (csrc/fast_score.cu) share of its roofline over
the traced run's profile stretch: the least time its launches' atlas shapes
allow (peaks.k1_bound_s) over torch.profiler's time of its kernel."""

from slam_bench import peaks

NAME = "k1_roofline"
UNIT = "%"
LAYER = "kernel K1"
MOVES = "tracked_fps"
SPANS = []
CALLS = [("orb_slam3_vio_fixes_tpu_torch.ops.fast", "fast_score_batch", "k1")]


def read(t: dict):
    p = t.get("profile")
    launches = p["calls"].get("k1") if p else None
    if not launches:
        return None
    dev_s = sum(s for name, _, s in p["ops"] if "fast_score_kernel" in name)
    if dev_s <= 0:
        return None
    atlases = [a[0] if a else k["imgs"] for a, k in launches]
    return 100.0 * sum(peaks.k1_bound_s(tuple(x.shape)) for x in atlases) / dev_s
