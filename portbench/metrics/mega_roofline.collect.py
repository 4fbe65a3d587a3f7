"""`mega_roofline.collect`: see portbench/metrics/_read.py's `mega_roofline`."""
from portbench.metrics._read import mega_roofline as read  # noqa: F401
