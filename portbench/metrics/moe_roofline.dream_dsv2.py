"""`moe_roofline.dream_dsv2`: see portbench/metrics/_dsv2.py's `moe_roofline`."""
from portbench.metrics._dsv2 import moe_roofline as read  # noqa: F401
