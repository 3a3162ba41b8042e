"""jac.device_ms: device time of the kernels launched inside the LM's
Jacobian and normal equations (spans ``lm.jacobian``: the error, the
masked Jacobian, J'J and J'e), per call, ms."""


def read(ctx):
    kernels = ctx.launched_in("lm.jacobian", cats=("kernel",))
    if not kernels or not ctx.calls:
        return None
    return ctx.device_us(kernels) * 1e-3 / ctx.calls
