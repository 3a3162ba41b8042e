"""lm.mfu_pct: the LM iterations' useful float32 operations (counted from
shapes, ``harness.peaks.lm_iteration_flops``, for the F frames each
iteration hands to ``spd_solve``) over the traced window's wall time times
the H100's float32 peak, %."""

from portbench.harness.peaks import FP32_FLOP_PER_S, lm_iteration_flops


def read(ctx):
    n_win = ctx.spans_in_window("pb.spd")
    if not n_win or ctx.window_s <= 0:
        return None
    d = ctx.dims
    flops = sum(F * lm_iteration_flops(d["m"], n, d["bodies"], d["joints"], d["sites"])
                for F, n in ctx.counts["spd"][-n_win:])
    return 100.0 * flops / (ctx.window_s * FP32_FLOP_PER_S)
