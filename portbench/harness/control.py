"""The check's control: the plain reference's forward kinematics, computed
in bfloat16 (the precision below the configuration's float32), put in the
place of the program's FK inside its pose solves and m-phase. The program's
solvers then work on markers known to bfloat16's ~3 significant digits,
which is what a port of the FK to bfloat16 would hand them. Its outputs
must come out not correct.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench.reference.fk import FK


def lower_precision_fk(model, device, dtype=torch.bfloat16):
    """``fk(params, qpos)`` with the program's FK signature and result type,
    computed by the reference FK in ``dtype`` from the program's current
    model arrays (its offsets included), returned in qpos's dtype."""
    from stac_mjx_tpu_torch.models.kinematics import FKResult

    ref = FK(model, device, dtype)

    def fk(params, qpos):
        for name in ("body_pos", "body_quat", "jnt_pos", "jnt_axis", "qpos0", "site_pos"):
            setattr(ref, name, getattr(params, name).to(dtype))
        fr = ref.frames(qpos.to(dtype))
        sites = ref.site_positions(fr)
        out = dict(fr, site_xpos=sites)
        return FKResult(**{f.name: out[f.name].to(qpos.dtype) for f in dataclasses.fields(FKResult)})

    return fk


def install(stac, model) -> None:
    """Put the control's FK in the place of a ``Stac``'s FK (its pose
    solvers' and its m-phase's)."""
    core = stac.stac_core_obj
    fk = lower_precision_fk(model, stac.device)
    core.fk = fk
    if core.gnik is not None:
        core.gnik.fk = fk
