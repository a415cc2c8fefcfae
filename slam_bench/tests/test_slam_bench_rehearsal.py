"""A tiny run of the benchmark on the CPU, start to end: the result line
the contract asks for, the per-layer metrics of a traced run, and no JAX,
no JAX package and (in the references) no SLAM package loaded."""

import ast
import json
import subprocess
import sys

from slam_bench import check
from slam_bench.tests import tiny

ROOT = tiny.ROOT
REHEARSE = """
import json, sys
from pathlib import Path
from slam_bench import run
from slam_bench.tests import tiny
cell = tiny.CELLS[sys.argv[2]][0]
bench, cell = tiny.bench(sys.argv[2], Path(sys.argv[1]), limits=tiny.no_limits(cell))
rc = run.emit(run.run_cell(bench, cell, 2**31 + 7, float(sys.argv[3]), sys.argv[4] == "1",
                           device="cpu"))
print(json.dumps({"rc": rc, "modules": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def rehearse(tmp_path, which, seconds, traced):
    p = subprocess.run([sys.executable, "-c", REHEARSE, str(tmp_path), which, str(seconds),
                        "1" if traced else "0"], cwd=ROOT, capture_output=True, text=True,
                       timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    lines = p.stdout.strip().splitlines()
    return json.loads(lines[-2]), json.loads(lines[-1]), p.stderr.strip().splitlines()


def test_rehearsal_prints_the_result_line(tmp_path):
    result, tail, err = rehearse(tmp_path, "stereo", 3.0, False)
    assert tail["rc"] == 0
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["attempted"] >= 2
    assert set(result["metrics"]) == {"tracked_fps", "frame_ms_p95", "setup_s"}
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert result["metrics"]["tracked_fps"]["unit"] == "frames/s"
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    numbers = [k for k in check.NUMBERS if k in tiny.no_limits("euroc_stereo.explore")]
    assert list(result["checks"]) == numbers
    for k in ("atlas_err", "k1_bad", "feat_bad", "k2_bad"):
        assert result["checks"][k]["value"] == 0, k
    # the numbers compared, beside their limits, are standard error's last lines
    assert [ln.split()[1] for ln in err[-len(numbers) - 1:-1]] == numbers
    assert err[-1] == "[check] correct = True"
    assert any("loop_corrections=" in ln for ln in err)
    # JAX, jaxlib, flax and the JAX package by their whole top-level names
    assert not set(tail["modules"]) & {"jax", "jaxlib", "flax", "orb_slam3_vio_fixes_tpu"}
    assert "orb_slam3_vio_fixes_tpu_torch" in tail["modules"]


def test_traced_rehearsal_reads_the_per_layer_metrics(tmp_path):
    result, tail, err = rehearse(tmp_path, "si", 6.0, True)
    names = set(result["metrics"])
    assert {"frame_build.ms", "vi_track_step.ms", "loop.ms_per_kf",
            "host.syncs_per_frame"} <= names
    bench = tiny.spec.Bench(ROOT)
    assert names <= {m["name"] for m in bench.per_layer("euroc_si.explore")}
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert any("imu_initialised_before_window=True" in ln for ln in err)
    assert {"kf_vel_err", "kf_bg_err", "gravity_deg"} <= set(result["checks"])
    assert not set(tail["modules"]) & {"jax", "jaxlib", "flax", "orb_slam3_vio_fixes_tpu"}


def _top_imports(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_references_import_nothing_of_the_program():
    for path in (ROOT / "slam_bench/reference").glob("*.py"):
        assert _top_imports(path) <= {"__future__", "functools", "math", "numpy", "torch",
                                      "slam_bench"}, path
    code = ("import sys; import slam_bench.reference.frame, slam_bench.reference.hamming, "
            "slam_bench.reference.trajectory, slam_bench.check; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120, check=True)
    mods = set(ast.literal_eval(p.stdout.strip()))
    assert not mods & {"orb_slam3_vio_fixes_tpu_torch", "orb_slam3_vio_fixes_tpu", "jax",
                       "jaxlib", "flax"}


def test_no_file_of_the_harness_imports_jax_or_the_jax_package():
    for path in (ROOT / "slam_bench").rglob("*.py"):
        assert not _top_imports(path) & {"jax", "jaxlib", "flax", "orb_slam3_vio_fixes_tpu"}, path


def test_facade_options_from_the_cell_file(tmp_path):
    """A cell file that runs the tracker pipelined, its poses a call late, is
    read and run without an edit to the harness."""
    from slam_bench import run, spec

    _, cell = tiny.bench("stereo", tmp_path)
    f = tmp_path / f"slam_bench/cells/{cell}.json"
    c = json.loads(f.read_text())
    c["facade"] = {"set": {"tracker.pipelined": True}, "pose_lag": 1}
    f.write_text(json.dumps(c))
    res = run.run_cell(spec.Bench(tmp_path), cell, 2**31 + 11, 3.0, False, device="cpu")
    assert res["correct"] is True and res["attempted"] >= 2
