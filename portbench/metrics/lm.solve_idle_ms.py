"""lm.solve_idle_ms (``.fit``): the device's idle time inside the LM's
solves (spans ``lm.solve`` of ``ops/gn_ik.py::GNIK._flat_lm``, eager or
replayed from a graph), per fit in the traced window, ms: how long the
fit's pose solves keep the card waiting on the host."""

from portbench.harness.spans import idle_us


def read(ctx):
    idle = idle_us(ctx, ("lm.solve",))
    if idle is None or not ctx.fits:
        return None
    return idle * 1e-3 / ctx.fits
