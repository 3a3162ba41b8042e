"""device.peak_mem_gb: the most memory the process's tensors held on the
card over the traced calls (``max_memory_allocated`` after
``reset_peak_memory_stats``), GB."""


def read(ctx):
    return ctx.peak_bytes / 1e9 if ctx.peak_bytes else None
