"""Command-line tools of the port, one module per tool of the repository's
`scripts/` folder and under the same file name:

  * `evaluate_ate`: RMS ATE of a trajectory file against ground truth;
  * `bench_scaling`: the landmark-sharded global BA at 1, 2, 4 and 8 shards
    on a full-map problem;
  * `train_vocabulary`: a BoW vocabulary from a directory of images;
  * `train_default_vocab`: the 10^4-word vocabulary from synthetic scenes;
  * `train_vocab_large`: the 10^5-word vocabulary from a larger, partly
    degraded synthetic corpus.

Each runs as `python -m orb_slam3_vio_fixes_tpu_torch.scripts.<name>` and
has a `main(argv=None)`. The ones that touch a device run on the CUDA card
unless `--cpu` is given; without a card they raise. The trainers write
under `build/vocab/` by default.
"""


def device_for(cpu: bool) -> str:
    """The device a tool runs on: "cpu" with --cpu, else "cuda" with
    PyTorch's deterministic mode switched on first, as the chip script runs
    it. Without a card the first CUDA tensor raises; nothing falls back to
    the host."""
    if cpu:
        return "cpu"
    from orb_slam3_vio_fixes_tpu_torch.utils import determinism

    determinism.enable()
    return "cuda"
