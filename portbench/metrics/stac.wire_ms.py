"""stac.wire_ms: device time of the host<->device copies that the entry
(``Stac.ik_only``) issues, per call, ms."""


def read(ctx):
    copies = ctx.launched_in("pb.entry", cats=("gpu_memcpy",))
    if not copies or not ctx.calls:
        return None
    return ctx.device_us(copies) * 1e-3 / ctx.calls
