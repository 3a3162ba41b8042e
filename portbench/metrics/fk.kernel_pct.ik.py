"""fk.kernel_pct.ik: the share of the forward-kinematics passes in the
traced window (spans ``fk`` of ``models/kinematics.py``) that launched the
FK kernel (spans ``fk.kernel`` of ``kinematics.fk_jump_cuda``, inside
them), %. A program without the kernel opens no ``fk.kernel`` and reads
nothing."""


def read(ctx):
    passes, launches = ctx.spans_in_window("fk"), ctx.spans_in_window("fk.kernel")
    if not passes or not launches:
        return None
    return 100.0 * launches / passes
