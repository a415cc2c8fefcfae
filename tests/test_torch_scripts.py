"""The port's tools (orb_slam3_vio_fixes_tpu_torch/scripts/) against the
repository's scripts/ and the JAX package on the same seeded inputs.

The JAX scripts run in a subprocess (`jax_scripts`), so that their
compile-cache and XLA_FLAGS settings stay out of the test worker; it
records what they compute: bench_scaling's problem, the image pairs the
two synthetic trainers feed their frame builds for seeds 0 and 1 (its
frame build replaced by a recorder), and the JSON keys bench_scaling
prints. Tolerances and why:
  * evaluate_ate: the printed RMS (and scale) and the port's numbers
    within 1e-9 of the JAX package's (the same float64 numpy);
  * bench_scaling's problem: byte for byte (the same numpy draws); its
    2-shard solve against JAX's distributed_bundle_adjust within
    test_torch_parallel.test_distributed_bundle_adjust's bars (centres
    and landmarks 1e-3, inliers equal);
  * the trainers' scenes byte for byte (numpy renders and noise);
    descriptors at test_torch_frame's bars for extract_batch (keypoint IoU
    >= 0.98, descriptor bits >= 99.5% on the common keypoints: the
    pyramid's resize sums weights in another order).
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from orb_slam3_vio_fixes_tpu.evaluation import ate as jate
from orb_slam3_vio_fixes_tpu.frontend import frame as jframe
from orb_slam3_vio_fixes_tpu.ops import orb as jorb
from orb_slam3_vio_fixes_tpu.optim import ba_core as jba
from orb_slam3_vio_fixes_tpu.parallel import sharded_ba as jsba
from orb_slam3_vio_fixes_tpu.slam_map import vocabulary as jvoc
from orb_slam3_vio_fixes_tpu.utils.cameras import Camera as JCamera
from orb_slam3_vio_fixes_tpu_torch.evaluation import ate as tate
from orb_slam3_vio_fixes_tpu_torch.frontend import frame as tframe
from orb_slam3_vio_fixes_tpu_torch.io import synthetic as tsyn
from orb_slam3_vio_fixes_tpu_torch.ops import orb as torb
from orb_slam3_vio_fixes_tpu_torch.parallel import sharded_ba as tsba
from orb_slam3_vio_fixes_tpu_torch.scripts import bench_scaling as tbs
from orb_slam3_vio_fixes_tpu_torch.scripts import evaluate_ate as tea
from orb_slam3_vio_fixes_tpu_torch.scripts import train_default_vocab as tdv
from orb_slam3_vio_fixes_tpu_torch.scripts import train_vocab_large as tvl
from orb_slam3_vio_fixes_tpu_torch.scripts import train_vocabulary as ttv
from orb_slam3_vio_fixes_tpu_torch.slam_map import vocabulary as tvoc

from test_torch_frame import _keys

pytest_plugins = ["torch_jax_release"]
# the sharded solve's shards run in threads of their own
pytestmark = pytest.mark.usefixtures("threads_end")

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(n_kf=8, n_lm=512, obs_per_kf=64)
# per trainer: its script, the frames a seed feeds its frame build
TRAINERS = {"default": ("train_default_vocab.py", 12), "large": ("train_vocab_large.py", 32)}
SEEDS = (0, 1)

_CAPTURE = r"""
import importlib.util, json, sys
import numpy as np

def load(name):
    spec = importlib.util.spec_from_file_location(name, f"scripts/{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

out = {}
bs = load("bench_scaling")
p = bs.make_problem(**SMALL, seed=0)
f = p.factors
for k in ("R", "t", "pose_fixed", "lm", "lm_valid", "lm_fixed"):
    out["problem_" + k] = np.asarray(getattr(p, k))
for k in ("pose_idx", "lm_idx", "uvr", "inv_sigma2", "valid"):
    out["problem_" + k] = np.asarray(getattr(f, k))
out["problem_bf"] = np.asarray(p.bf)
out["problem_cam"] = np.asarray([p.cam.fx, p.cam.fy, p.cam.cx, p.cam.cy], np.float32)


class Enough(Exception):
    pass


for tag, (script, per_seed) in TRAINERS.items():
    mod = load(script[:-3])
    frames = []

    def record(img_l, img_r, *args, _frames=frames, _n=per_seed * len(SEEDS)):
        _frames.append((np.asarray(img_l), np.asarray(img_r)))
        if len(_frames) == _n:
            raise Enough
        class F:
            desc = np.zeros((1, 8), np.uint32)
            valid = np.zeros(1, bool)
        return F

    mod.build_stereo_frame = record
    try:
        mod.harvest()
    except Enough:
        pass
    for i, (l, r) in enumerate(frames):
        out[f"{tag}_{i}_l"], out[f"{tag}_{i}_r"] = l, r
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def jax_scripts(tmp_path_factory):
    """What the JAX scripts compute (see the module's docstring), run in a
    subprocess from the repository root."""
    path = tmp_path_factory.mktemp("jax_scripts") / "capture.npz"
    code = (f"SMALL = {SMALL!r}\nTRAINERS = {TRAINERS!r}\nSEEDS = {SEEDS!r}\n" + _CAPTURE)
    out = subprocess.run([sys.executable, "-c", code, str(path)], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env={**_env(), "SCALING_DEVICES": "8"})
    assert out.returncode == 0, out.stderr[-4000:]
    with np.load(path) as z:
        return dict(z)


def _env():
    return {**os.environ, "JAX_PLATFORMS": "cpu"}


# -- evaluate_ate --

def _write_tum(path, ts, pos, scale_ts=1.0, sep=" "):
    q = np.tile([0.0, 0.0, 0.0, 1.0], (len(ts), 1))
    with open(path, "w") as fh:
        fh.write("# timestamp tx ty tz qx qy qz qw\n")
        for t, p, qq in zip(ts, pos, q):
            stamp = f"{int(round(t * scale_ts))}" if scale_ts != 1.0 else f"{t:.6f}"
            fh.write(sep.join([stamp] + [f"{v:.9f}" for v in (*p, *qq)]) + "\n")


@pytest.fixture(scope="module")
def trajectories(tmp_path_factory):
    """A ground truth in TUM and in EuRoC's ns CSV layout, and an estimate
    rotated, shifted, scaled by 1.3 and noisy, at stamps offset by 3 ms."""
    d = tmp_path_factory.mktemp("ate")
    rng = np.random.default_rng(5)
    ts = 1403636579.0 + 0.05 * np.arange(120)
    gt = np.stack([np.cos(0.05 * np.arange(120)), np.sin(0.04 * np.arange(120)),
                   0.01 * np.arange(120)], 1) * 3.0
    c, s = np.cos(0.4), np.sin(0.4)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    est = 1.3 * gt @ R.T + np.array([0.5, -1.0, 2.0]) + rng.normal(0, 0.02, gt.shape)
    _write_tum(d / "gt.txt", ts, gt)
    _write_tum(d / "gt.csv", ts, gt, scale_ts=1e9, sep=",")
    _write_tum(d / "est.txt", ts[::2] + 0.003, est[::2])
    return d


@pytest.mark.parametrize("gt,flags", [("gt.txt", []), ("gt.txt", ["--scale", "--verbose"]),
                                      ("gt.csv", ["--verbose"]),
                                      ("gt.csv", ["--scale", "--max-dt", "0.001"])])
def test_evaluate_ate(trajectories, capsys, gt, flags):
    """The port's CLI prints the JAX script's lines (and exit code), and its
    RMS and scale agree with the JAX package's ate to 1e-9."""
    args = [str(trajectories / gt), str(trajectories / "est.txt"), *flags]
    ref = subprocess.run([sys.executable, "scripts/evaluate_ate.py", *args], cwd=ROOT,
                         capture_output=True, text=True, timeout=120, env=_env())
    rc = tea.main(args)
    got = capsys.readouterr()
    assert rc == ref.returncode
    assert got.out == ref.stdout and got.err == ref.stderr
    assert ("absolute_translational_error.rmse" in got.out) == (rc == 0)
    ts_gt, p_gt = tea.load_tum(args[0])
    ts_es, p_es = tea.load_tum(args[1])
    assert ts_gt.max() < 1e14
    max_dt = float(flags[flags.index("--max-dt") + 1]) if "--max-dt" in flags else 0.02
    t_out = tate.ate_rmse(ts_gt, p_gt, ts_es, p_es, "--scale" in flags, max_dt)
    j_out = jate.ate_rmse(ts_gt, p_gt, ts_es, p_es, "--scale" in flags, max_dt)
    assert t_out[2] == j_out[2]
    if rc == 0:
        np.testing.assert_allclose(t_out[:2], j_out[:2], rtol=0, atol=1e-9)


# -- bench_scaling --

def test_make_problem_same_arrays(jax_scripts):
    p = tbs.make_problem(**SMALL, seed=0, device="cpu")
    ours = {"R": p.R, "t": p.t, "pose_fixed": p.pose_fixed, "lm": p.lm, "lm_valid": p.lm_valid,
            "lm_fixed": p.lm_fixed, "uvr": p.factors.uvr, "inv_sigma2": p.factors.inv_sigma2,
            "valid": p.factors.valid}
    for k, v in ours.items():
        ref = jax_scripts["problem_" + k]
        assert v.numpy().dtype == ref.dtype and v.numpy().tobytes() == ref.tobytes(), k
    for k in ("pose_idx", "lm_idx"):
        ref = jax_scripts["problem_" + k]
        got = getattr(p.factors, k).numpy()
        assert got.astype(ref.dtype).tobytes() == ref.tobytes(), k
    assert np.float32(p.bf).tobytes() == jax_scripts["problem_bf"].tobytes()
    cam = np.asarray([p.cam.fx, p.cam.fy, p.cam.cx, p.cam.cy], np.float32)
    assert cam.tobytes() == jax_scripts["problem_cam"].tobytes()
    assert p.factors.valid.sum() > 0.9 * len(p.factors.valid)


def _printed_keys(func: str) -> list:
    """The key sets of the dict literals in the JAX script's `func`, in
    source order (the JSON lines it prints)."""
    tree = ast.parse((ROOT / "scripts" / "bench_scaling.py").read_text())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == func)
    dicts = sorted((d for d in ast.walk(fn) if isinstance(d, ast.Dict)
                    and any(isinstance(k, ast.Constant) and k.value == "metric"
                            for k in d.keys)), key=lambda d: d.lineno)
    return [{k.value for k in d.keys} for d in dicts]


def test_bench_scaling_main(monkeypatch, capsys, tmp_path):
    """`main --cpu` at the small size prints the JAX script's JSON lines:
    one per shard count with its keys, then the summary with its keys,
    `platform` "cpu", and the summary written to SCALING_OUT."""
    monkeypatch.setattr(tbs, "PROBLEM", SMALL)
    monkeypatch.setattr(tbs, "REPS", 1)
    monkeypatch.setenv("SCALING_OUT", str(tmp_path / "summary.json"))
    assert tbs.main(["--cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    per_count, summary_keys = _printed_keys("main")
    assert [x["devices"] for x in lines[:-1]] == list(tbs.COUNTS) == [1, 2, 4, 8]
    for x in lines[:-1]:
        assert set(x) == per_count and x["metric"] == "distributed_gba_solve_s"
        assert x["value"] > 0
    summary = lines[-1]
    assert set(summary) == summary_keys and summary["metric"] == "gba_scaling_efficiency"
    assert summary["platform"] == "cpu" and set(summary["speedups"]) == {"1", "2", "4", "8"}
    assert json.loads((tmp_path / "summary.json").read_text()) == summary


def test_two_shard_solve_matches_jax():
    """The twin's problem on Mesh(["cpu"] * 2) against the JAX package's
    distributed_bundle_adjust on two of the conftest's virtual devices,
    the same partitioned problem; two runs of the port's byte-identical
    (bench_n keeps each timed solve)."""
    tp = tbs.make_problem(**SMALL, seed=0, device="cpu")
    f = tp.factors
    jcam = JCamera.pinhole(458.0, 458.0, 376.0, 240.0)
    jp = jba.BAProblem(
        R=jnp.asarray(tp.R.numpy()), t=jnp.asarray(tp.t.numpy()),
        pose_fixed=jnp.asarray(tp.pose_fixed.numpy()), lm=jnp.asarray(tp.lm.numpy()),
        lm_valid=jnp.asarray(tp.lm_valid.numpy()), lm_fixed=jnp.asarray(tp.lm_fixed.numpy()),
        factors=jba.ReprojFactors(jnp.asarray(f.pose_idx.numpy().astype(np.int32)),
                                  jnp.asarray(f.lm_idx.numpy().astype(np.int32)),
                                  jnp.asarray(f.uvr.numpy()), jnp.asarray(f.inv_sigma2.numpy()),
                                  jnp.asarray(f.valid.numpy())),
        cam=jcam, bf=jnp.float32(45.8))
    cfg = dict(n_rounds=2, n_iters=8, solver="cg", cg_iters=40)
    jmesh = JMesh(np.array(jax.devices()[:2]), ("lm",))
    jout, jinl, _ = jsba.distributed_bundle_adjust(jsba.partition_problem(jp, 2), jmesh,
                                                   jba.LMConfig(**cfg))
    outs = []
    tbs.bench_n(tp, 2, tbs.CONFIG, reps=2, outs=outs)
    assert tbs.CONFIG == type(tbs.CONFIG)(**cfg)
    (R, t, lm, inl), again = outs
    assert all(torch.equal(a, b) for a, b in zip(outs[0], again))
    valid = tsba.partition_problem(tp, 2).factors.valid.numpy()

    def centres(R, t):
        return -np.einsum("pji,pj->pi", np.asarray(R), np.asarray(t))

    np.testing.assert_allclose(centres(R, t), centres(jout.R, jout.t), atol=1e-3)
    np.testing.assert_allclose(lm.numpy(), np.asarray(jout.lm), atol=1e-3)
    np.testing.assert_array_equal(inl.numpy()[valid], np.asarray(jinl)[valid])
    assert inl.numpy()[valid].mean() > 0.9
    counts = tbs.shard_factor_counts(tp, 2)
    assert counts.sum() == len(f.valid) and len(valid) == 2 * counts.max()


# -- train_vocabulary --

@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """Four rendered 240x352 frames as 8-bit PNG files."""
    from PIL import Image

    d = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(11)
    world = tsyn.make_world(rng, n_points=700, extent=8.0, depth_range=(3.0, 12.0))
    seq = tsyn.make_stereo_sequence(rng, n_frames=4, h=240, w=352, fx=260.0, baseline=0.2,
                                    world=world)
    for i, img in enumerate(seq.imgs_l):
        Image.fromarray(np.clip(np.rint(img), 0, 255).astype(np.uint8)).save(d / f"{i:03d}.png")
    (d / "notes.txt").write_text("not an image")
    return d


def _agree(jf, tf):
    """(keypoint IoU, descriptor bit agreement on the common keypoints)."""
    jk = _keys(np.asarray(jf.uv), np.asarray(jf.octave), np.asarray(jf.valid))
    tk = _keys(tf.uv.numpy(), tf.octave.numpy(), tf.valid.numpy())
    common = jk.keys() & tk.keys()
    ji = np.array([jk[k] for k in common])
    ti = np.array([tk[k] for k in common])
    jd = np.asarray(jf.desc).view(np.uint8)
    td = tf.desc.numpy().view(np.uint8)
    return (len(common) / len(jk.keys() | tk.keys()),
            1.0 - np.unpackbits(jd[ji] ^ td[ti], axis=1).mean())


def test_train_vocabulary_corpus(image_dir):
    """The directory walk keeps the four PNGs; per image the port's
    orb.extract finds the same number of descriptors as JAX's, at
    test_torch_frame's bars; the corpus is their union."""
    paths = ttv.image_paths(str(image_dir), 300)
    assert [Path(p).name for p in paths] == [f"{i:03d}.png" for i in range(4)]
    images = [ttv.load_gray(p) for p in paths]
    assert images[0].dtype == np.float32 and images[0].shape == (240, 352)
    corpus = ttv.corpus_of(images, 1000, "cpu")
    jcfg = jorb.ORBConfig(n_features=1000)
    n_jax = 0
    for img in images:
        jf = jorb.extract(jnp.asarray(img), jcfg)
        tf = torb.extract(torch.from_numpy(img), torb.ORBConfig(n_features=1000))
        assert int(tf.valid.sum()) == int(np.asarray(jf.valid).sum())
        iou, bits = _agree(jf, tf)
        assert iou >= 0.98 and bits >= 0.995, (iou, bits)
        n_jax += int(np.asarray(jf.valid).sum())
    assert corpus.dtype == np.uint32 and corpus.shape == (n_jax, 8) and n_jax > 1000


def test_train_vocabulary_cli(image_dir, tmp_path, capsys):
    """The CLI on the CPU trains and saves a file that the JAX package's
    vocabulary.load reads to the port's arrays."""
    out = tmp_path / "vocab.npz"
    assert ttv.main([str(image_dir), str(out), "--depth", "3", "--cpu"]) == 0
    assert f"saved 1000-word vocabulary to {out}" in capsys.readouterr().out
    jv = jvoc.load(str(out))
    tv = tvoc.load(str(out), "cpu")
    nodes, weights = tvoc.to_numpy(tv)
    assert (jv.branching, jv.depth) == (10, 3)
    np.testing.assert_array_equal(np.asarray(jv.nodes), nodes)
    np.testing.assert_array_equal(np.asarray(jv.weights), weights)
    assert np.isfinite(weights).all() and (weights > 1e-3).sum() > 100


def test_load_gray_without_readers(image_dir, monkeypatch):
    """With imageio and PIL both absent, load_gray raises: nothing else
    reads image files."""
    path = str(image_dir / "000.png")
    img = ttv.load_gray(path)
    for name in ("imageio", "imageio.v3", "PIL", "PIL.Image"):
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError, match="imageio or PIL"):
        ttv.load_gray(path)
    assert img.shape == (240, 352)


# -- train_default_vocab / train_vocab_large --

def _port_frames(tag, seed):
    return list(tdv.seed_frames(seed) if tag == "default" else tvl.seed_frames(seed))


@pytest.mark.parametrize("tag", TRAINERS)
@pytest.mark.parametrize("seed", SEEDS)
def test_trainer_scenes_equal_jax(jax_scripts, tag, seed):
    """The image pairs a seed feeds the frame build against the JAX
    script's: the sprite worlds of seed 1, with the default trainer's noise
    and the large trainer's degrade_images, byte for byte. Seed 0's loop
    walls turn the camera through so3_exp, which the reference evaluates
    with XLA's float32 sin and cos and the port with numpy's: their last
    bit moves a few sprite edges by a fraction of a gray level (as in
    test_torch_frame.test_port_generator_matches_reference), so there every
    pixel is within 0.5 gray levels and under 1% of the seed's pixels
    differ by more than 1e-3; the noise on top is the same draw."""
    per_seed = TRAINERS[tag][1]
    frames = _port_frames(tag, seed)
    assert len(frames) == per_seed
    diffs = []
    for i, pair in enumerate(frames):
        k = f"{tag}_{seed * per_seed + i}"
        for eye, got in zip("lr", pair):
            ref = jax_scripts[f"{k}_{eye}"]
            assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape == (240, 352)
            if seed % 2:
                assert got.tobytes() == ref.tobytes(), (k, eye)
            diffs.append(np.abs(got - ref))
    diffs = np.stack(diffs)
    assert diffs.max() < 0.5 and (diffs > 1e-3).mean() < 0.01, (diffs.max(), (diffs > 1e-3).mean())


@pytest.mark.parametrize("tag", TRAINERS)
def test_trainer_first_frame_descriptors(tag):
    """The first harvested frame through each package's stereo frame build
    at the trainer's ORBConfig: keypoints and descriptors at
    test_torch_frame's bars; the harvested corpus row count is the port's
    valid count."""
    mod = tdv if tag == "default" else tvl
    img_l, img_r = _port_frames(tag, 0)[0]
    cfg = mod.ORB_CONFIG
    jcfg = jorb.ORBConfig(n_features=cfg.n_features, n_levels=cfg.n_levels)
    jf = jframe.build_stereo_frame(jnp.asarray(img_l), jnp.asarray(img_r), jnp.float32(0.0),
                                   JCamera.pinhole(260.0, 260.0, 176.0, 120.0),
                                   jnp.float32(52.0), jcfg)
    tf = tframe.build_stereo_frame_impl(torch.from_numpy(img_l), torch.from_numpy(img_r),
                                        torch.zeros(()), tdv.CAM, tdv.BF, cfg)
    iou, bits = _agree(jf, tf)
    assert int(np.asarray(jf.valid).sum()) > 300
    assert iou >= 0.98 and bits >= 0.995, (iou, bits)
    d = tdv.frame_descriptors(img_l, img_r, "cpu", cfg)
    assert d.dtype == np.uint32 and len(d) == int(tf.valid.sum())


def test_trainer_default_outputs():
    """The trainers write under build/vocab/, never into the JAX
    package's checked-in assets."""
    for mod, name in ((tdv, "vocab_b10d4.npz"), (tvl, "vocab_b10d5.npz")):
        out = Path(mod.DEFAULT_OUT).resolve()
        assert out == ROOT / "build" / "vocab" / name
        assert not out.is_relative_to(ROOT / "orb_slam3_vio_fixes_tpu")


@pytest.mark.slow
def test_jax_default_vocab_corpus_reference():
    """The JAX script's harvest() whole on the CPU: the corpus count that
    chip_smoke.py's phase 24 holds the port's within 1% of
    (chip_smoke.JAX_DEFAULT_CORPUS)."""
    import chip_smoke

    code = ("import importlib.util\n"
            "spec = importlib.util.spec_from_file_location(\n"
            "    't', 'scripts/train_default_vocab.py')\n"
            "m = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(m)\n"
            "print('CORPUS', len(m.harvest()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=3600, env=_env())
    assert out.returncode == 0, out.stderr[-4000:]
    n = int(out.stdout.split("CORPUS")[-1])
    print(f"JAX train_default_vocab.harvest(): {n} descriptors")
    assert n == chip_smoke.JAX_DEFAULT_CORPUS
