"""device.idle_pct (``.ik``, ``.fit``: one per end-to-end metric it moves):
the share of the traced window in which no kernel, copy or memset runs on
the card (one minus their union), %."""


def read(ctx):
    if ctx.window_s <= 0 or not ctx.trace.in_window():
        return None
    return 100.0 * (1.0 - ctx.trace.busy_us() / ctx.trace.window_us)
