"""`host_ms.collect`: see portbench/metrics/_read.py's `host_ms`."""
from portbench.metrics._read import host_ms as read  # noqa: F401
