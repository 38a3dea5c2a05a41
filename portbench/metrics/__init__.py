"""One reader per metric, end-to-end or per-layer, found by the metric's
name (or by its name up to the first dot).  ``read(ctx)`` returns the
metric's value (``run.Context``), or None where the run holds nothing for
it to read."""
