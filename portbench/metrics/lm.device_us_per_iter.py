"""lm.device_us_per_iter (``.fit``, ``.ik``): device time of the kernels,
copies and memsets launched inside the LM's iterations (spans ``lm.iter``)
per iteration in the traced window, us."""


def read(ctx):
    n = ctx.spans_in_window("lm.iter")
    events = ctx.launched_in("lm.iter")
    if not n or not events:
        return None
    return ctx.device_us(events) / n
