"""mphase.device_ms: device time of the kernels launched inside the
closed-form offset solves (``m_opt_closed_form``), per fit, ms."""


def read(ctx):
    kernels = ctx.launched_in("pb.mphase", cats=("kernel",))
    if not kernels or not ctx.fits:
        return None
    return ctx.device_us(kernels) * 1e-3 / ctx.fits
