"""pg.ms_per_iter: the traced window's wall time over its projected-gradient
iterations (each solve's slowest lane's), ms."""


def read(ctx):
    n_win = ctx.spans_in_window("pb.pg")
    iters = sum(ctx.counts["pg"][-n_win:]) if n_win else 0
    if not iters:
        return None
    return ctx.window_s * 1e3 / iters
