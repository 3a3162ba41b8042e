"""lm.graph_hit_pct (``.fit``, ``.ik``: one per end-to-end metric it
moves): the share of the LM's solves in the traced window that replayed
from a CUDA graph (spans ``lm.replay`` of ``ops/gn_ik.py::_LMGraph``) among
all its solves (spans ``lm.solve`` of ``GNIK._flat_lm``), %."""


def read(ctx):
    solves = ctx.spans_in_window("lm.solve")
    if not solves:
        return None
    return 100.0 * ctx.spans_in_window("lm.replay") / solves
