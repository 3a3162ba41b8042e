"""The clip axis over processes (port of ``stac_mjx_tpu/parallel/mesh.py``).

The JAX package is single-controller: one process sees every chip, and a 1-D
mesh over them shards the clip axis. Here each card has a process of its own
(``torchrun --nproc-per-node N``), and the clip axis is the torch.distributed
world group, one rank per card: ``init_distributed`` joins it, ``clip_group``
describes it (ranks, this rank, this rank's device) and ``shard_clips``
gives this rank's contiguous block of clips. The frame-sharded fit
all-reduces its m-phase statistics over the group
(``ops.solver.m_opt_closed_form``); the ik's clips need no collective until
the results are gathered.

Nothing here switches backend or device on its own: NCCL for a CUDA device,
gloo for the CPU, or whatever the caller names (gloo also carries CUDA
tensors, which is how two ranks share one card: NCCL refuses that).
"""

from __future__ import annotations

import dataclasses
import logging
import os

import torch
import torch.distributed as dist

from stac_mjx_tpu_torch.bridge import resolve_device

CLIP_AXIS = "clips"


@dataclasses.dataclass(frozen=True)
class ClipGroup:
    """The clip axis: ``group`` (a torch.distributed process group, or None
    in a single process), ``ranks`` (the group's ranks in axis order, one
    entry per block of clips), this process's ``rank`` and its ``device``."""

    group: object
    ranks: tuple
    rank: int
    device: torch.device

    @property
    def size(self) -> int:
        return len(self.ranks)


def _local_device(device) -> torch.device:
    """``device``, or by default this process's card: ``cuda:$LOCAL_RANK``."""
    if device is not None:
        return torch.device(device)
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def init_distributed(backend: str | None = None, device=None, **kwargs) -> None:
    """Join the process group torchrun describes (one process per card).

    Reads torchrun's environment (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``; ``init_method`` and ``world_size``/``rank`` in kwargs
    take their place). A no-op in a single process (no ``WORLD_SIZE``), as
    the JAX one is, and when the group exists. ``device`` is this process's
    device (default ``cuda:$LOCAL_RANK``); ``backend`` defaults to nccl for a
    CUDA device and gloo for the CPU.
    """
    if dist.is_initialized() or ("WORLD_SIZE" not in os.environ and "world_size" not in kwargs):
        return
    device = _local_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(resolve_device(device))
    if backend == "nccl":
        kwargs.setdefault("device_id", device)
    kwargs.setdefault("init_method", "env://")
    dist.init_process_group(backend, **kwargs)


def clip_group(device=None) -> ClipGroup:
    """The world group as the clip axis, with this process's ``device``
    (default ``cuda:$LOCAL_RANK``, as for ``init_distributed``)."""
    device = _local_device(device)
    if not dist.is_initialized():
        return ClipGroup(None, (0,), 0, device)
    return ClipGroup(dist.group.WORLD, tuple(range(dist.get_world_size())), dist.get_rank(), device)


def shard_clips(batched, group: ClipGroup | None = None):
    """This rank's contiguous block of the leading clip axis of ``batched``.

    The whole array where one rank serves, or (with a warning) where the
    clip count does not divide over the ranks: every rank then solves every
    clip, as the JAX version replicates then.
    """
    from stac_mjx_tpu_torch.parallel.distributed import local_clip_range

    group = clip_group() if group is None else group
    n = batched.shape[0]
    if group.size <= 1:
        return batched
    if n % group.size:
        logging.getLogger(__name__).warning(
            "shard_clips: %d clips do not divide over %d ranks; every rank takes all of them. "
            "Pad the recording or pick n_frames_per_clip so the clip count is divisible.",
            n,
            group.size,
        )
        return batched
    lo, hi = local_clip_range(n, group)
    return batched[lo:hi]
