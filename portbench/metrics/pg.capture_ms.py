"""pg.capture_ms: host time in the CUDA-graph captures of the projected
gradient (spans ``pg.capture`` of ``ops/solver.py::graph_replay``: the
warm-ups and the capture) per PG solve in the traced window (spans
``pb.pg``), ms."""

from portbench.harness.spans import host_us


def read(ctx):
    n = ctx.spans_in_window("pb.pg")
    us = host_us(ctx, "pg.capture")
    if not n or us is None:
        return None
    return us * 1e-3 / n
