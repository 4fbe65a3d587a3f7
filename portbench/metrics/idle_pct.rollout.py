"""`idle_pct.rollout`: see portbench/metrics/_read.py's `idle_pct`."""
from portbench.metrics._read import idle_pct as read  # noqa: F401
