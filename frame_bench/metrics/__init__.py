"""Per-layer metric readers, one module a metric, found by name
(``harness/spec.py``): ``read(run)`` returns the metric's value from a
finished run, or None where the run has nothing to read. Modules whose
name starts with ``_`` are helpers, not metrics."""
