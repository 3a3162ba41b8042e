"""dist.collective_ms: device time of the NCCL kernels (the m-phase's
all-reduce, the results' all-gathers) on rank 0, per job, ms."""


def read(ctx):
    nccl = [d for d in ctx.trace.in_window(("kernel",)) if "nccl" in d[0].lower()]
    if not nccl or not ctx.calls:
        return None
    return ctx.device_us(nccl) * 1e-3 / ctx.calls
