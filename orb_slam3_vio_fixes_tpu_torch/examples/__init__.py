"""Per-app entry points (ports of the scripts in the repository's examples/
directory), run as modules from the repository root, e.g.

    python -m orb_slam3_vio_fixes_tpu_torch.examples.stereo_inertial_vio \
        settings.yaml seq_dir out.txt --vio-config cfg.json
"""
