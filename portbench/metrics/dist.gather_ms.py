"""dist.gather_ms: host time in the results' all-gathers and their copies
to the host (spans ``dist.all_gather`` of
``parallel/distributed.py::fetch_arrays``) per job, on rank 0, ms."""

from portbench.harness.spans import host_us


def read(ctx):
    us = host_us(ctx, "dist.all_gather")
    if us is None or not ctx.calls:
        return None
    return us * 1e-3 / ctx.calls
