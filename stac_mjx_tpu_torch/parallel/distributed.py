"""Multi-process runs: per-rank data blocks and the sharded pipeline
(port of ``stac_mjx_tpu/parallel/distributed.py``).

One process per card joins the world group (``init_distributed``, called by
``cli --distributed`` under ``torchrun``). Each rank takes a contiguous
block of the recording (``local_clip_range``): the fit shards frames and
all-reduces its m-phase statistics, the ik shards clips and needs no
collective. The results are all-gathered in rank order so that every rank
returns the full arrays (``fetch_arrays``), and rank 0 writes the h5
artifacts.

torch has no global array: where the JAX package assembles a pod-global
sharded array, ``make_global_clips`` / ``make_global_frames`` return this
rank's block on its device. In a single process every helper takes the plain
local path, so the same driver runs on one card or several.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from stac_mjx_tpu_torch.parallel.mesh import CLIP_AXIS, ClipGroup, clip_group, init_distributed
from stac_mjx_tpu_torch.utils.profiling import annotate

__all__ = [
    "CLIP_AXIS",
    "init_distributed",
    "pod_mesh",
    "local_clip_range",
    "make_global_clips",
    "make_global_frames",
    "fetch_arrays",
    "psum_error_stats",
    "run_stac_distributed",
]


def pod_mesh(device=None) -> ClipGroup:
    """The clip axis over every rank of the world group, this process on
    ``device`` (default ``cuda:$LOCAL_RANK``)."""
    return clip_group(device)


def local_clip_range(n_clips: int, mesh: ClipGroup | None = None) -> tuple[int, int]:
    """[start, stop) of the clip indices THIS rank's block covers.

    Clips are laid out contiguously over the axis order (``mesh.ranks``), so
    a rank owns a contiguous block; slice the recording with it before
    loading frames. Raises ValueError when the clips do not divide over the
    axis, or when this rank's entries are not contiguous in it.
    """
    if mesh is None:
        mesh = pod_mesh()
    n_dev = mesh.size
    per_dev = n_clips // n_dev
    if per_dev * n_dev != n_clips:
        raise ValueError(
            f"{n_clips} clips do not divide over {n_dev} devices; pad the "
            f"recording or choose n_frames_per_clip so clips % devices == 0"
        )
    idxs = [i for i, r in enumerate(mesh.ranks) if r == mesh.rank]
    if not idxs:
        return 0, 0
    if idxs != list(range(idxs[0], idxs[-1] + 1)):
        raise ValueError(
            "this rank's entries are not contiguous in the clip axis order; "
            "order the axis with each rank's blocks together (rank-major) "
            "before using contiguous clip loading"
        )
    return idxs[0] * per_dev, (idxs[-1] + 1) * per_dev


def make_global_clips(local_clips: np.ndarray, mesh: ClipGroup | None = None) -> torch.Tensor:
    """This rank's clip block (from ``local_clip_range``) on its device."""
    if mesh is None:
        mesh = pod_mesh()
    return torch.as_tensor(np.ascontiguousarray(local_clips), device=mesh.device)


def make_global_frames(local_frames: np.ndarray, mesh: ClipGroup | None = None) -> torch.Tensor:
    """``make_global_clips`` for a flat (frames, 3K) block: the sharded fit's
    shard axis is frames."""
    return make_global_clips(local_frames, mesh)


def fetch_arrays(tree, mesh: ClipGroup | None = None, dim: int = 0):
    """numpy arrays of a tensor, or a tuple, list or dict of them, each being
    this rank's block: with more than one rank, the blocks are all-gathered
    along ``dim`` in rank order (every block of a tensor the same shape), so
    every rank returns the full arrays. Collective: every rank calls it.
    Each tensor's gather and copy to the host is a span ``dist.all_gather``."""
    if mesh is None:
        mesh = pod_mesh()
    if isinstance(tree, dict):
        return {k: fetch_arrays(v, mesh, dim) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(fetch_arrays(v, mesh, dim) for v in tree)
    with annotate("dist.all_gather"):
        t = tree.detach().contiguous()
        if mesh.size > 1:
            blocks = [torch.empty_like(t) for _ in range(dist.get_world_size(mesh.group))]
            dist.all_gather(blocks, t, group=mesh.group)
            t = torch.cat(blocks, dim=dim)
        return t.cpu().numpy()


def _local_frame_count(n_total: int, n_dev: int, what: str) -> int:
    usable = (n_total // n_dev) * n_dev
    if usable == 0:
        raise ValueError(
            f"{n_total} {what} cannot shard over {n_dev} devices — need at least one per device"
        )
    if usable < n_total:
        logging.getLogger(__name__).warning(
            "truncating %s from %d to %d to divide over %d devices", what, n_total, usable, n_dev
        )
    return usable


def psum_error_stats(errors: torch.Tensor, mesh: ClipGroup | None = None):
    """Mean and standard deviation of per-frame errors over every rank's
    block: the count, the sum and the sum of squares all-reduced (SUM), so
    every rank reports the same statistics. Collective over ``mesh``."""
    if mesh is None:
        mesh = pod_mesh()
    stats = torch.stack([errors.new_tensor(float(errors.numel())), errors.sum(), (errors * errors).sum()])
    if mesh.group is not None:
        dist.all_reduce(stats, group=mesh.group)
    n, s, ss = stats
    mean = s / n
    var = torch.clamp(ss / n - mean * mean, min=0.0)
    return mean, torch.sqrt(var)


def run_stac_distributed(cfg, base_path=None, mesh: ClipGroup | None = None, dtype=torch.float32):
    """The multi-process twin of ``main.run_stac``: every rank runs it.

    - every rank composes the same config, loads the recording and builds
      the same model, on its own device;
    - fit: the first n_fit_frames (truncated to divide over the ranks) shard
      over the ranks by frames (``Stac.fit_offsets_sharded``: lockstep, the
      m-phase all-reduced);
    - ik: clips shard per ``local_clip_range``, each rank solving its block
      (``Stac.ik_only_global``);
    - results are all-gathered so every rank holds the full outputs; rank 0
      writes the h5 artifacts (the schema of ``main.run_stac``). With
      skip_fit_offsets the offsets come from the fit h5.

    Each rank reads the whole recording and slices its block on the host.
    Returns ``(fit_h5_path, ik_h5_path or None)``.
    """
    from stac_mjx_tpu_torch import io
    from stac_mjx_tpu_torch.bridge import resolve_device
    from stac_mjx_tpu_torch.main import infer_qvels, make_stac
    from stac_mjx_tpu_torch.utils.batching import batch_kp_data, handle_edge_effects

    base_path = Path(base_path) if base_path is not None else Path.cwd()
    mesh = pod_mesh() if mesh is None else mesh
    n_dev = mesh.size
    proc0 = mesh.rank == 0
    log = logging.getLogger(__name__)

    kp_data, kp_names = io.load_data(cfg, base_path=base_path)
    kp_data = np.asarray(kp_data)
    stac = make_stac(cfg, kp_names, device=resolve_device(mesh.device), dtype=dtype, base_path=base_path)

    fit_path = base_path / cfg.stac.fit_offsets_path
    ik_path = base_path / cfg.stac.ik_only_path

    if cfg.stac.skip_fit_offsets:
        log.info("fit skipped; reading offsets from %s", fit_path)
        _, fit_data = io.load_stac_data(fit_path)
    else:
        n_fit = _local_frame_count(min(int(cfg.stac.n_fit_frames), kp_data.shape[0]), n_dev, "fit frames")
        lo, hi = local_clip_range(n_fit, mesh)
        kp_local = make_global_frames(kp_data[lo:hi].astype(np.float32), mesh)
        fit_data = stac.fit_offsets_sharded(kp_local, mesh)
        if proc0:
            io.save_data_to_h5(config=cfg, file_path=fit_path, **fit_data.as_dict())
            log.info("fit artifact written: %s", fit_path)
    offsets = fit_data.offsets

    if cfg.stac.skip_ik_only:
        return fit_path, None

    clip_len = int(cfg.stac.n_frames_per_clip)
    if kp_data.shape[0] % clip_len != 0:
        raise ValueError(f"cannot split {kp_data.shape[0]} frames into clips of {clip_len}")
    batched = batch_kp_data(kp_data, clip_len, continuous=bool(cfg.stac.continuous)).astype(np.float32)
    lo, hi = local_clip_range(batched.shape[0], mesh)
    ik_data = stac.ik_only_global(make_global_clips(batched[lo:hi], mesh), offsets, mesh)

    if cfg.stac.continuous:
        ik_data = handle_edge_effects(ik_data, clip_len)
    if cfg.stac.infer_qvels:
        ik_data.qvel = infer_qvels(stac, ik_data.qpos, clip_len)

    if proc0:
        io.save_data_to_h5(config=cfg, file_path=ik_path, **ik_data.as_dict())
        log.info("ik artifact written: %s", ik_path)
    return fit_path, ik_path
