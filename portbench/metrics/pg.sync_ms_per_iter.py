"""pg.sync_ms_per_iter: host time in the lanes' host syncs (spans
``lanes.sync`` of ``utils/lanes.py::while_lanes``: the read of
``active.any()``) per PG iteration (spans ``pg.iter``) in the traced
window, ms."""

from portbench.harness.spans import host_us


def read(ctx):
    n = ctx.spans_in_window("pg.iter")
    us = host_us(ctx, "lanes.sync")
    if not n or us is None:
        return None
    return us * 1e-3 / n
