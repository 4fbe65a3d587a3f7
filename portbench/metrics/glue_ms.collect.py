"""`glue_ms.collect`: see portbench/metrics/_read.py's `glue_ms`."""
from portbench.metrics._read import glue_ms as read  # noqa: F401
