"""The benchmark of the PyTorch / CUDA port on one NVIDIA H100.

`run.py` is the command (`python3 -m slam_bench.run`); `spec.py` reads
`BENCHMARK.json` and finds the configuration, traffic, cell and metric
files it names; `scene.py` and `render.py` make the camera stream;
`check.py` and `reference/` decide `correct`; `trace.py`, `peaks.py` and
`metrics/` give the per-layer metrics.
"""
