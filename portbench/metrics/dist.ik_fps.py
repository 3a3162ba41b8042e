"""dist.ik_fps: frames posed per second of time inside the traced window's
``Stac.ik_only_global`` calls (span ``pb.ik_global``) on rank 0, under the
profiler. The four-card cell's ik rate, read per layer: its untraced rate
spreads too widely from run to run to hold to a bound."""


def read(ctx):
    spans = ctx.spans_within("pb.ik_global")
    busy_s = sum(e - s for s, e in spans) * 1e-6
    if not spans or not ctx.frames_per_call or busy_s <= 0:
        return None
    return len(spans) * ctx.frames_per_call / busy_s
