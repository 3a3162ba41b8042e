"""pg.launch_ms_per_iter: host time in the CUDA-graph replays of the
projected gradient (spans ``pg.replay`` of ``ops/solver.py::graph_replay``:
the launch and the outputs' clones) per PG iteration (spans ``pg.iter``) in
the traced window, ms."""

from portbench.harness.spans import host_us


def read(ctx):
    n = ctx.spans_in_window("pg.iter")
    us = host_us(ctx, "pg.replay")
    if not n or us is None:
        return None
    return us * 1e-3 / n
