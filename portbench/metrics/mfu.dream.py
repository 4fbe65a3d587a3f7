"""`mfu.dream`: see portbench/metrics/_read.py's `mfu_dream`."""
from portbench.metrics._read import mfu_dream as read  # noqa: F401
