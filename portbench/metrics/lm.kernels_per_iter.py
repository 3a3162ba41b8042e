"""lm.kernels_per_iter: kernel launches in the traced window per LM
iteration (each iteration hands one batch of systems to ``spd_solve``)."""


def read(ctx):
    iters = ctx.spans_in_window("pb.spd")
    kernels = [d for d in ctx.trace.in_window(("kernel",))]
    if not iters or not kernels:
        return None
    return len(kernels) / iters
