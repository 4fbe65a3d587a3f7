"""`traj_raster_roofline.rollout`: see portbench/metrics/_read.py's `traj_raster_roofline`."""
from portbench.metrics._read import traj_raster_roofline as read  # noqa: F401
