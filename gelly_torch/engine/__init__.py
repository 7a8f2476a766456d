"""Single-device summary-aggregation engine."""
