"""The multi-device layer: a single-controller device mesh (`mesh`), the
row-sharded descriptor search (`sharded_matching`) and the landmark-sharded
bundle adjustment (`sharded_ba`); the landmark-sharded full-map VI BA is
`optim.vi_global_ba.run_global_vi_ba_sharded`."""

from orb_slam3_vio_fixes_tpu_torch.parallel.mesh import Mesh, P, shard_map  # noqa: F401
