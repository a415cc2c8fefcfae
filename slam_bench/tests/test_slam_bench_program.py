"""`python -m slam_bench.program` (the program's own spans and counters over
a cell, outside the benchmark's window): its per-layer rows on a made-up
export, and a tiny CPU run of the stereo cell start to end."""

import json
import subprocess
import sys

import pytest

from slam_bench import program
from slam_bench.tests import tiny

ROOT = tiny.ROOT
TRACE = """
import json, sys
sys.path.insert(0, %r)
from pathlib import Path
from slam_bench import program
from slam_bench.tests import tiny
bench, cell = tiny.bench(sys.argv[2], Path(sys.argv[1]))
out = program.trace_cell(bench, bench.cell(cell), 2**31 + 7, 6, 1, 0.5, device="cpu")
print(json.dumps(out))
""" % str(ROOT)


def _span(name, t0, t1, frame=0):
    return {"name": name, "start_ns": int(t0 * 1e6), "end_ns": int(t1 * 1e6), "frame": frame}


def test_layers_of_an_export():
    spans = [_span("track_stereo", 0, 100, 0), _span("frame_build", 0, 10, 0),
             _span("track_step", 10, 60, 0), _span("track.pull.wait", 60, 61, 0),
             _span("kf_create_map", 61, 71, 0), _span("kf_local_ba", 71, 91, 0),
             _span("loop", 91, 99, 0), _span("loop.verify", 92, 96, 0),
             _span("loop.verify", 96, 98, 0),
             _span("track_stereo", 100, 150, 1), _span("frame_build", 100, 112, 1),
             _span("track_step", 112, 140, 1), _span("track_ref_kf", 130, 139, 1),
             _span("track_ref_kf.wait", 138, 139, 1), _span("record.wait", 140, 142, 1)]
    rows = program.layers({"spans": spans, "counters": {"match.wide_retries": 1}},
                          {"spans": [_span("facade", 0, 2500)], "counters": {}})
    assert rows == pytest.approx({
        "frame_build_ms": 11.0, "track_step_ms": 39.0, "kf_stages_ms_per_kf": 30.0,
        "loop_ms_per_kf": 8.0, "verifications_per_kf": 2.0, "wait_ms_per_frame": 2.0,
        "retry_share": 100.0, "frames": 2, "keyframes": 1, "facade_s": 2.5})
    # no keyframe in the stretch: no per-keyframe rows
    assert set(program.layers({"spans": spans[:4], "counters": {}})) == {
        "frame_build_ms", "track_step_ms", "wait_ms_per_frame", "retry_share", "frames",
        "keyframes"}


def test_tiny_stereo_run_prints_the_tables(tmp_path):
    p = subprocess.run([sys.executable, "-c", TRACE, str(tmp_path), "stereo"], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    err = p.stderr.splitlines()
    out = json.loads(p.stdout.strip().splitlines()[-1])
    rows = out["layers"]
    step = "track_step_ms"
    assert {"frame_build_ms", step, "wait_ms_per_frame", "retry_share", "facade_s"} <= set(rows)
    assert rows["frames"] == 6 and rows["facade_s"] > 0
    assert 0 <= rows["retry_share"] <= 100
    # one tracer a part: the set-up's holds the facade, the stretch's six frames
    assert {"facade", "facade.determinism"} <= {s["name"] for s in out["setup"]["spans"]}
    assert out["stretch"]["frames"] == 6
    assert any(ln.startswith("[program] setup facade ") for ln in err)
    assert any(ln.startswith("[program] track_stereo ") for ln in err)
    assert any(ln.startswith(f"[program] layers {step} ") for ln in err)
    assert any(ln.startswith("[gaps] program frames=1 ") for ln in err)
    assert [c["traced"] for c in out["cost"]] == list(program.COST_ORDER)
    assert all(c["frames"] >= 1 for c in out["cost"])
