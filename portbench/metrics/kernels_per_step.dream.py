"""`kernels_per_step.dream`: see portbench/metrics/_read.py's `kernels_per_step`."""
from portbench.metrics._read import kernels_per_step as read  # noqa: F401
