"""spd.device_ms: device time of the kernels launched inside the program's
``spd`` spans (``ops/spd.py::spd_solve_cuda``, around each launch of the
batched Cholesky kernel K1), per traced call, ms. A program without the
span reads nothing."""


def read(ctx):
    kernels = ctx.launched_in("spd", cats=("kernel",))
    if not kernels or not ctx.calls:
        return None
    return ctx.device_us(kernels) * 1e-3 / ctx.calls
