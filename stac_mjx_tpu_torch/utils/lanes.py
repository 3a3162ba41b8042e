"""The semantics of a ``lax.while_loop`` under ``jax.vmap``, over batched tensors.

Under ``jax.vmap`` a while loop whose condition differs between lanes runs
its body on every lane for as long as *any* lane's condition holds, and
keeps a finished lane's state by a per-lane select. The JAX package's
projected-gradient and linesearch Gauss-Newton solvers rely on exactly this
when they are vmapped over frames or clips; ``while_lanes`` reproduces it
with one host sync (``.any()``, in a span ``lanes.sync``) per loop step.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from stac_mjx_tpu_torch.utils.profiling import annotate

State = Sequence[torch.Tensor]


def _select(active: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    return torch.where(active.reshape(active.shape + (1,) * (old.ndim - 1)), new, old)


def while_lanes(
    cond: Callable[[State], torch.Tensor],
    body: Callable[[State, torch.Tensor], State],
    state: State,
) -> tuple:
    """Run ``state = body(state)`` lane by lane while ``cond(state)`` holds.

    Every tensor of ``state`` has the lane axis first; ``cond`` returns a
    (B,) bool mask. The body runs on all lanes while any lane is active and
    gets that mask as its second argument (a nested loop may stop on it; the
    values it gives the inactive lanes are thrown away). Each inactive lane
    keeps its state bitwise: the update is ``torch.where(active, new, old)``.
    """
    state = tuple(state)
    while True:
        active = cond(state)
        with annotate("lanes.sync"):
            go_on = bool(active.any())
        if not go_on:
            return state
        new = body(state, active)
        state = tuple(_select(active, n, o) for n, o in zip(new, state))
