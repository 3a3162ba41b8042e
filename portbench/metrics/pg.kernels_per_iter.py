"""pg.kernels_per_iter: kernels in the traced window over its
projected-gradient iterations (each solve's slowest lane's)."""


def read(ctx):
    n_win = ctx.spans_in_window("pb.pg")
    iters = sum(ctx.counts["pg"][-n_win:]) if n_win else 0
    kernels = ctx.trace.in_window(("kernel",))
    if not iters or not kernels:
        return None
    return len(kernels) / iters
