"""`mfu.dream_dsv2`: see portbench/metrics/_dsv2.py's `mfu`."""
from portbench.metrics._dsv2 import mfu as read  # noqa: F401
