"""fk.device_ms: device time of the kernels launched inside the forward
kinematics passes (spans ``fk`` of ``models/kinematics.py``), per call, ms."""


def read(ctx):
    kernels = ctx.launched_in("fk", cats=("kernel",))
    if not kernels or not ctx.calls:
        return None
    return ctx.device_us(kernels) * 1e-3 / ctx.calls
