"""The benchmark is data: BENCHMARK.json agrees with the files it names,
and a cell, a configuration, a traffic mix and a per-layer metric added as
files are found without editing any file."""

import hashlib
import json
import shutil

import numpy as np

from slam_bench import check, render, scene, spec
from slam_bench.tests import tiny

ROOT = tiny.ROOT


def digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "slam_bench").rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_benchmark_json_agrees_with_its_files():
    b = spec.Bench(ROOT)
    for c in b.data["configs"]:
        cfg = b.config(c["name"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert (ROOT / cfg["settings"]).is_file()
        render.model(cfg["camera"].get("model", "pinhole"))
    for w in b.data["workloads"]:
        b.traffic(w["traffic"])
        c = b.cell_file(w["name"])
        assert c["limits"] and set(c["limits"]) <= set(check.NUMBERS)
        assert c["max_fps"] > 0
        assert {"tracked_fps", "setup_s"} <= {m["name"] for m in b.end_to_end(w["name"])}
        assert b.per_layer(w["name"])
    for m in b.data["per_layer"]:
        r = b.reader(m["name"])
        assert (r.UNIT, r.LAYER, r.MOVES) == (m["unit"], m["layer"], m["moves"])
        for w in m["workloads"]:
            assert m["moves"] in {e["name"] for e in b.end_to_end(w)}


def test_added_files_are_found_without_edits(tmp_path):
    before = digest(ROOT)
    shutil.copytree(ROOT / "slam_bench", tmp_path / "slam_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    d = tmp_path / "slam_bench"
    cfg = json.loads((d / "configs/euroc_stereo.json").read_text())
    cfg["name"] = "euroc_stereo_wide"
    (d / "configs/euroc_stereo_wide.json").write_text(json.dumps(cfg))
    data["configs"].append({"name": "euroc_stereo_wide", "source": "a test",
                            "file": "slam_bench/configs/euroc_stereo_wide.json",
                            "reduced": cfg["reduced"], "why": "a test"})
    # laps of a 3 m circle looking outward, as data: centripetal acceleration,
    # a constant yaw rate, sprites laid along the first lap only
    traffic = json.loads((d / "traffic/explore.json").read_text())
    w, r = 2 * np.pi / 3.6, 3.0
    traffic["path"] = {"fps": 20, "v0": [r * w, 0.0, 0.0], "p0": [0.0, 0.0, -r],
                       "rot0": [0.0, np.pi, 0.0],
                       "accel": [[0, -r * w * w, w, 0.0], [2, r * w * w, w, np.pi / 2]],
                       "rate": [[1, -w, 0.0, np.pi / 2]]}
    traffic["world"][0]["until_frame"] = 72
    (d / "traffic/laps.json").write_text(json.dumps(traffic))
    cell = "euroc_stereo_wide.laps"
    data["workloads"].append({"name": cell, "config": "euroc_stereo_wide",
                              "traffic": "laps", "chips": 1, "why": "a test"})
    (d / f"cells/{cell}.json").write_text(json.dumps(
        {"max_fps": 8, "limits": {"k2_bad": 0},
         "facade": {"set": {"tracker.pipelined": True},
                    "after_warmup": ["activate_localization_mode"]}}))
    (d / "metrics/kf.per_frame.py").write_text(
        'NAME = "kf.per_frame"\nUNIT = "keyframes/frame"\nLAYER = "keyframe stages"\n'
        'MOVES = "tracked_fps"\n'
        'SPANS = [("orb_slam3_vio_fixes_tpu_torch.frontend.tracking", "kf_create_map", '
        '"kf_create_map")]\n'
        'CALLS = [("orb_slam3_vio_fixes_tpu_torch.ops.matching", "hamming_match", "k2")]\n\n\n'
        'def read(t):\n'
        '    return len(t["spans"].get("kf_create_map", ())) / t["frames"]\n')
    data["per_layer"].append({"name": "kf.per_frame", "unit": "keyframes/frame",
                              "better": "lower", "source": "program_span",
                              "layer": "keyframe stages", "moves": "tracked_fps",
                              "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))

    b = spec.Bench(tmp_path)
    assert b.cell(cell)["config"] == "euroc_stereo_wide"
    assert b.config("euroc_stereo_wide")["sensor"] == "STEREO"
    c = b.cell_file(cell)
    assert c["limits"] == {"k2_bad": 0} and c["max_fps"] == 8
    assert c["facade"]["set"] == {"tracker.pipelined": True}
    per = [m["name"] for m in b.per_layer(cell)]
    assert per == ["kf.per_frame"]
    reader = b.reader("kf.per_frame")
    assert reader.CALLS[0][2] == "k2"
    assert reader.read({"frames": 4, "spans": {"kf_create_map": [0.1, 0.2]}}) == 0.5
    assert "frame_ms_p95" not in {m["name"] for m in b.end_to_end(cell)}
    # the new traffic's path is a circle, with IMU samples, by the one generator
    imu = dict(b.config("euroc_stereo_inertial")["imu"], noise_gyro=0.0, noise_acc=0.0,
               walk_gyro=0.0, walk_acc=0.0)
    R_wc, t_wc, v_w, _, samples = scene.path(b.traffic("laps")["path"], 73, imu,
                                             np.random.default_rng(0))
    np.testing.assert_allclose(np.linalg.norm(t_wc[:, [0, 2]], axis=1), r, atol=2e-3)
    np.testing.assert_allclose(t_wc[72], t_wc[0], atol=1e-2)
    np.testing.assert_allclose(R_wc[72], R_wc[0], atol=1e-9)
    # looking outward
    assert (np.einsum("ni,ni->n", R_wc[:, :, 2], t_wc) > 0.99 * r).all()
    assert len(samples) == 73 and samples[1].shape == (10, 7)
    assert digest(ROOT) == before
