"""Per-layer metric readers, one file a metric, loaded by name."""
