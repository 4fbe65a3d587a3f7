"""`attn_span_ms.dream_dsv2`: see portbench/metrics/_dsv2.py's `attn_span_ms`."""
from portbench.metrics._dsv2 import attn_span_ms as read  # noqa: F401
