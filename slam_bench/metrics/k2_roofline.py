"""k2_roofline: Kernel K2's (csrc/hamming.cu) share of its roofline over the
traced run's profile stretch: the least time of its calls' shapes and
admissible pairs (peaks.k2_bound_s) over torch.profiler's time of its
kernel (the column keys' memset is not counted)."""

from slam_bench import peaks

NAME = "k2_roofline"
UNIT = "%"
LAYER = "kernel K2"
MOVES = "tracked_fps"
SPANS = []
CALLS = [("orb_slam3_vio_fixes_tpu_torch.ops.matching", "hamming_match", "k2")]


def read(t: dict):
    p = t.get("profile")
    launches = p["calls"].get("k2") if p else None
    if not launches:
        return None
    dev_s = sum(s for name, _, s in p["ops"] if "match_kernel" in name)
    if dev_s <= 0:
        return None
    bound = 0.0
    for a, k in launches:
        c = {**dict(zip(("desc_q", "desc_t", "mask", "cols"), a)), **k}
        m = c["mask"]
        bound += peaks.k2_bound_s(m.shape[0], m.shape[1], bool(c["cols"]), int(m.sum()))
    return 100.0 * bound / dev_s
