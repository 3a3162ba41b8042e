"""dist.fit_s: seconds per ``Stac.fit_offsets_sharded`` call (span
``pb.fit_sharded``) in the traced window, on rank 0, under the profiler.
The four-card cell's calibration time, read per layer: its untraced time
spreads too widely from run to run to hold to a bound."""


def read(ctx):
    spans = ctx.spans_within("pb.fit_sharded")
    if not spans:
        return None
    return sum(e - s for s, e in spans) * 1e-6 / len(spans)
