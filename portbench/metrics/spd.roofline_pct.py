"""spd.roofline_pct: the least time of the systems handed to ``spd_solve``
in the traced window (``harness.peaks.spd_bound_s`` of each call's F and
n) over the device time of the kernels launched inside those calls, %."""

from portbench.harness.peaks import spd_bound_s


def read(ctx):
    n_win = ctx.spans_in_window("pb.spd")
    kernels = ctx.launched_in("pb.spd", cats=("kernel",))
    if not n_win or not kernels:
        return None
    bound = sum(spd_bound_s(F, n) for F, n in ctx.counts["spd"][-n_win:])
    return 100.0 * bound / (ctx.device_us(kernels) * 1e-6)
