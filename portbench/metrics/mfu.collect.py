"""`mfu.collect`: see portbench/metrics/_read.py's `mfu`."""
from portbench.metrics._read import mfu as read  # noqa: F401
