"""One reader per per-layer metric: ``read(ctx) -> float | None`` over a
``portbench.harness.measure.Context`` (the traced window's trace, the
counts of the spans, the calls traced). A reader that finds nothing to
read returns None, and the metric is left out of the line. A metric split
by the end-to-end metric it moves (``device.idle_pct.ik``, ``.fit``) may
share one reader, named without the last part."""
