"""Per-layer metric readers, one file a metric (``<metric>.py``), each with
``read(rec, ctx)``: the value from a traced run's record, or None where the
record holds nothing to read."""
