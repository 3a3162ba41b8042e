"""What the readers of the program's own spans share (``profiling.annotate``
in ``stac_mjx_tpu_torch``: ``lm.iter``, ``fk``, ``pg.replay``, ...): host
time inside the window's spans of a name, and the device's idle time inside
them. A reader of a span the program does not open finds none and returns
None."""

from __future__ import annotations

from portbench.harness.trace import gaps, union_s


def merged(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def overlap_us(a, b) -> float:
    """Length of the intersection of two lists of sorted disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def host_us(ctx, name: str) -> float | None:
    """Host time inside the window's spans of that name (their union), us;
    None where there is no such span."""
    spans = ctx.spans_within(name)
    return union_s(spans, *ctx.trace.window) if spans else None


def idle_us(ctx, names) -> float | None:
    """The device's idle time inside the window's spans of those names: the
    stretches of the window in which no kernel, copy or memset runs
    (``trace.gaps``), intersected with the union of the spans, us. None
    where there is no such span or no device event in the window (a trace
    without the card)."""
    spans = [s for n in names for s in ctx.spans_within(n)]
    busy = [(d[2], d[3]) for d in ctx.trace.in_window()]
    if not spans or not busy:
        return None
    return overlap_us(gaps(busy, *ctx.trace.window), merged(spans))
