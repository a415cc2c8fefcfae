"""The stereo-inertial loop's gravity reading on the card across image-noise
draws: chip_smoke.py's phase-12 scenario (88 frames at 752x480) with the
inertial LoopCloser, on the scenario's own noise and on each of
chip_smoke.SI_LOOP_NOISE_SEEDS, one line per run with the corrections, the
ATE, the body-frame gravity error over the keyframes (median and max,
degrees) and the velocity error, and the float32 matmul / convolution
settings in force inside the first pre-init tracking step (TF32 must be
off there, not only in BA). Runs in PyTorch's deterministic mode, so each
draw has one reading. Needs a CUDA device; about 100 s a run.

    python -m orb_slam3_vio_fixes_tpu_torch.gravity_spread

The JAX package's readings on the same frames come from
tests/test_torch_inertial_loop.py (test_jax_inertial_loop_reference_at_full_width
and test_jax_inertial_loop_gravity_across_noise_at_full_width, on a CPU).
"""

from __future__ import annotations

import time
from unittest import mock

import numpy as np
import torch


def main() -> None:
    import chip_smoke  # the scenario, tracker and checks (repository root)

    from orb_slam3_vio_fixes_tpu_torch import kernels
    from orb_slam3_vio_fixes_tpu_torch.frontend import tracking
    from orb_slam3_vio_fixes_tpu_torch.slam_map import vocabulary
    from orb_slam3_vio_fixes_tpu_torch.utils import determinism

    card = chip_smoke.card_facts()
    determinism.enable()            # before any CUDA work
    dev = torch.device("cuda")
    print(f"[card] {card}", flush=True)
    kernels.build()
    vocab = vocabulary.default_vocabulary(dev)
    step = tracking.track_step_impl
    seen = []

    def pre_init_step(*a, **k):
        if not seen:
            seen.append(dict(matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
                             cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
                             float32_matmul_precision=torch.get_float32_matmul_precision(),
                             deterministic=torch.are_deterministic_algorithms_enabled()))
            print(f"[precision] first pre-init tracking step: {seen[0]}", flush=True)
        return step(*a, **k)

    for seed in (None, *chip_smoke.SI_LOOP_NOISE_SEEDS):
        seq = chip_smoke.make_si_loop_sequence(noise_seed=seed)
        closer = chip_smoke.loop_closer(seq, vocab, dev, **chip_smoke.SI_LOOP_LCFG)
        t0 = time.perf_counter()
        with mock.patch.object(tracking, "track_step_impl", pre_init_step):
            tr, _ = chip_smoke.run_pass(seq, dev, build=lambda s, d: (
                chip_smoke.build_si_loop_tracker(s, d, loop_closer=closer)))
        rmse = chip_smoke.trajectory_ate(seq.ts, seq.t_wc, tr, seq.imgs_l.shape[0])
        order = np.asarray(tr.kf_order)
        errs, v_err = chip_smoke.gravity_and_velocity(
            seq, *(getattr(tr.state, f).cpu().numpy()[order]
                   for f in ("kf_R", "kf_t", "kf_ts", "kf_vel")))
        print(f"[gravity] noise_seed={seed} state={tr.track_state} imu_ready={tr.imu_ready} "
              f"keyframes={len(tr.kf_order)} corrections={closer.n_corrections} "
              f"ate_m={rmse!r} gravity_deg_median={float(np.median(errs))!r} "
              f"gravity_deg_max={float(errs.max())!r} velocity_rel_err={v_err!r} "
              f"wall={time.perf_counter() - t0:.1f}s", flush=True)
        del tr, closer


if __name__ == "__main__":
    main()
