"""Offline drawers and viewer (port of orb_slam3_vio_fixes_tpu/viz/).
matplotlib and PIL are imported inside the calls that draw or save."""

from orb_slam3_vio_fixes_tpu_torch.viz.frame_drawer import draw_frame
from orb_slam3_vio_fixes_tpu_torch.viz.map_drawer import draw_map, draw_trajectory
from orb_slam3_vio_fixes_tpu_torch.viz.viewer import OfflineViewer

__all__ = ["draw_frame", "draw_map", "draw_trajectory", "OfflineViewer"]
