"""stac.idle_ms: the device's idle time inside the entry's host work
(spans ``stac.upload``, ``stac.fetch`` and ``stac.package`` of
``stac.py``), per call, ms."""

from portbench.harness.spans import idle_us


def read(ctx):
    idle = idle_us(ctx, ("stac.upload", "stac.fetch", "stac.package"))
    if idle is None or not ctx.calls:
        return None
    return idle * 1e-3 / ctx.calls
