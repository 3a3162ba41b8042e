"""lm.idle_us_per_iter (``.fit``, ``.ik``: one per end-to-end metric it
moves): the device's idle time inside the LM's iterations (spans
``lm.iter`` of ``ops/gn_ik.py::GNIK._flat_lm``) per iteration in the traced
window, us: how long an LM iteration keeps the card waiting on the host."""

from portbench.harness.spans import idle_us


def read(ctx):
    n = ctx.spans_in_window("lm.iter")
    idle = idle_us(ctx, ("lm.iter",))
    if not n or idle is None:
        return None
    return idle / n
