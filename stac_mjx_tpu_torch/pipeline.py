"""STAC drivers over batched tensors (port of ``stac_mjx_tpu/pipeline.py``).

Both pose modes of the JAX package: ``sequential`` (its default and the
reference's parity path: frame t starts from frame t-1's solution, each frame
a full-q solve then one solve per body part) and ``lockstep`` (every frame of
a pass solved at once; part passes batched with parts on the batch axis, or
chained). ``fit_offsets_program`` runs the root solve, N x (pose pass,
m-phase) and a final pose pass; ``ik_only_program`` runs each clip's root
solve, then its pose pass (lockstep: one flat batch over every frame of
every clip, optionally hierarchical; sequential: the per-clip chains side by
side, the clips riding the lanes). Given a torch.distributed group,
``fit_offsets_program`` fits one rank's block of frames with the m-phase
statistics all-reduced over the group.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from stac_mjx_tpu_torch.models.kinematics import JNT_BALL, JNT_FREE, KinParams
from stac_mjx_tpu_torch.ops.stac_core import StacCore, make_qs
from stac_mjx_tpu_torch.utils import prng

# Batched part-pass item cap: above P * F items the lockstep part passes fall
# back to the sequential part chain (see pose_optimization).
_PART_BATCH_MAX_ITEMS = 32768


@dataclasses.dataclass(frozen=True)
class StacConfigStatic:
    """Pipeline configuration; fields and defaults as in the JAX package's
    ``StacConfigStatic`` (``Stac`` resolves the automatic values)."""

    n_iters: int
    n_sample_frames: int
    m_reg_coef: float
    root_kp_idx: int  # -1 => no root optimization
    root_dims: int  # 7 (free) or 4 (slide)
    do_root_opt: bool
    indiv_parts: tuple  # per-part qpos masks (np.ndarray bool (nq,))
    trunk_kps: Any  # np.ndarray bool (K,)
    pose_mode: str = "sequential"  # "sequential" (parity) | "lockstep"
    root_opt_passes: int = 2
    part_opt_mode: str = "sequential"  # lockstep part passes: "batched" | "sequential"
    hier_stride: int = 0
    hier_fine_iters: int = 0
    fit_warm_iters: int = 0


def _root_masks(cfg, q0):
    nq = q0.shape[-1]
    qs_to_opt = torch.zeros(nq, dtype=torch.bool, device=q0.device)
    qs_to_opt[: cfg.root_dims] = True
    kps = np.repeat(np.asarray(cfg.trunk_kps), 3)
    return qs_to_opt, torch.as_tensor(kps, device=q0.device).to(q0.dtype)


def _part_masks(cfg, device) -> list[torch.Tensor]:
    return [torch.as_tensor(np.asarray(p, bool), device=device) for p in cfg.indiv_parts]


# ---------------------------------------------------------------- root phase


def _root_passes(solve, cfg, params, kp_frames, q0, lb, ub) -> torch.Tensor:
    """cfg.root_opt_passes root-only solves of (C, ·) lanes, each pass
    seeded with the root keypoint's xyz, against the trunk keypoints only."""
    root_xyz = kp_frames[:, 3 * cfg.root_kp_idx : 3 * cfg.root_kp_idx + 3]
    qs_to_opt, kps_to_opt = _root_masks(cfg, q0)
    q = q0
    for _ in range(cfg.root_opt_passes):
        q = torch.cat([root_xyz, q[:, 3:]], dim=1)
        res = solve(params, kp_frames, qs_to_opt, kps_to_opt, q, lb, ub)
        q = make_qs(q, qs_to_opt, res.params)
    return q


def root_optimization(core: StacCore, cfg, params, kp_frame, q0, lb, ub) -> torch.Tensor:
    """Root solves with the single-frame solver (``q_opt``): on one frame
    (kp_frame (3K,), q0 (nq,)), or on C clips' first frames at once
    (kp_frame (C, 3K), q0 (C, nq)) as the JAX per-clip vmap does."""
    if q0.ndim == 2:
        return _root_passes(core.q_opt, cfg, params, kp_frame, q0, lb, ub)
    return _root_passes(core.q_opt, cfg, params, kp_frame[None], q0[None], lb, ub)[0]


def root_optimization_batch(core: StacCore, cfg, params, kp_frames, q0, lb, ub) -> torch.Tensor:
    """root_optimization for C clips through the batched solver
    (``q_opt_batch``, the lockstep ik): kp_frames (C, 3K), q0 (C, nq)."""
    return _root_passes(core.q_opt_batch, cfg, params, kp_frames, q0, lb, ub)


# ---------------------------------------------------------------- pose phase


def _quat_spans(topo) -> tuple:
    """qpos addresses of unit quaternions (free: qadr+3, ball: qadr)."""
    spans = []
    for j in range(topo.njnt):
        t = int(topo.jnt_type[j])
        qa = int(topo.jnt_qposadr[j])
        if t == JNT_FREE:
            spans.append(qa + 3)
        elif t == JNT_BALL:
            spans.append(qa)
    return tuple(spans)


def interp_seeds(topo, q_coarse: torch.Tensor, stride: int, n_frames: int) -> torch.Tensor:
    """Per-frame warm starts from strided coarse solves (hierarchical ik).

    q_coarse (C, Fcc, nq) holds frames 0, s, 2s, ... of each clip. Frame t
    seeds from the lerp of its bracketing coarse frames; quaternion spans are
    sign-aligned before and renormalized after (nlerp). Frames past the last
    coarse frame clamp to it. The weights are rounded to float32 first, as
    in the JAX version.
    """
    C, Fcc, nq = q_coarse.shape
    t = np.arange(n_frames)
    il = np.minimum(t // stride, Fcc - 1)
    ir = np.minimum(il + 1, Fcc - 1)
    w = torch.as_tensor(
        ((t - il * stride) / stride).astype(np.float32), device=q_coarse.device
    ).to(q_coarse.dtype)[None, :, None]
    left = q_coarse[:, il]
    right = q_coarse[:, ir]
    seed = left * (1.0 - w) + right * w
    for a in _quat_spans(topo):
        lq = left[..., a : a + 4]
        rq = right[..., a : a + 4]
        dot = torch.sum(lq * rq, dim=-1, keepdim=True)
        rq = torch.where(dot < 0, -rq, rq)
        q = lq * (1.0 - w) + rq * w
        norm = torch.sqrt(torch.clamp(torch.sum(q * q, -1, keepdim=True), min=1e-12))
        seed[..., a : a + 4] = q / norm
    return seed


def _solve_frame(core, cfg, params, q0, kp_t, lb, ub, kps_to_opt, qs_all):
    """One frame of C clips (q0 (C, nq), kp_t (C, 3K)): the full-q solve,
    then one solve per part in part order, each re-masked through make_qs.
    Returns (q, the last solve's solver error)."""
    res = core.q_opt(params, kp_t, qs_all, kps_to_opt, q0, lb, ub)
    q = res.params
    err = res.error
    for part_mask in _part_masks(cfg, q0.device):
        res = core.q_opt(params, kp_t, part_mask, kps_to_opt, q, lb, ub)
        q = make_qs(q, part_mask, res.params)
        err = res.error
    return q, err


def _pose_sequential(core, cfg, params, kp_clips, q_init, lb, ub):
    """The sequential pose pass of C clips side by side: kp_clips
    (C, F, 3K), q_init (C, nq). Frame t of each clip starts from that
    clip's frame t-1. Returns (q_last (C, nq), qposes (C, F, nq))."""
    kps_to_opt = torch.ones(kp_clips.shape[-1], dtype=kp_clips.dtype, device=kp_clips.device)
    qs_all = torch.ones(q_init.shape[-1], dtype=torch.bool, device=kp_clips.device)
    q, qposes = q_init, []
    for t in range(kp_clips.shape[1]):
        q, _ = _solve_frame(core, cfg, params, q, kp_clips[:, t], lb, ub, kps_to_opt, qs_all)
        qposes.append(q)
    return q, torch.stack(qposes, dim=1)


def _part_passes(core, cfg, params, kp_data, qposes, kps_to_opt, lb, ub) -> torch.Tensor:
    """The lockstep part passes over (F, ·) frames, at the full budget.

    Batched (``part_opt_mode="batched"`` and P * F <= _PART_BATCH_MAX_ITEMS):
    one solve of P * F items, parts on the batch axis with a mask per item,
    each part's masked dims then written back in part order. Otherwise the
    chain: part p's solve starts from the result of part p-1.
    """
    F = kp_data.shape[0]
    masks = _part_masks(cfg, kp_data.device)
    P = len(masks)
    if cfg.part_opt_mode == "batched" and P * F <= _PART_BATCH_MAX_ITEMS:
        qs_pf = torch.repeat_interleave(torch.stack(masks), F, dim=0)
        res = core.q_opt_batch(
            params, kp_data.repeat(P, 1), qs_pf, kps_to_opt, qposes.repeat(P, 1), lb, ub
        )
        sols = res.params.reshape(P, F, -1)
        for i, part_mask in enumerate(masks):
            qposes = make_qs(qposes, part_mask, sols[i])
        return qposes
    for part_mask in masks:
        res = core.q_opt_batch(params, kp_data, part_mask, kps_to_opt, qposes, lb, ub)
        qposes = make_qs(qposes, part_mask, res.params)
    return qposes


def pose_optimization(
    core: StacCore,
    cfg: StacConfigStatic,
    params: KinParams,
    kp_data: torch.Tensor,
    q_init: torch.Tensor,
    lb: torch.Tensor,
    ub: torch.Tensor,
    maxiter: int | None = None,
    root_reseed: bool = True,
):
    """Pose solves over a clip kp_data (F, 3K).

    sequential: frame by frame, frame t starting from frame t-1 (q_init
    (nq,) starts frame 0). lockstep: every frame at once from q_init (nq,)
    broadcast or (F, nq); with root_reseed each frame's root xyz starts at
    its own root keypoint; ``maxiter`` overrides the full-q pass's budget
    (gn-lm), never the part passes'.

    Returns (q_last, qposes (F, nq), xpos, xquat, marker_sites, errors (F,)),
    errors being the per-frame mean marker distance in meters. q_last is the
    LAST frame's pose, the carry the fit hands to its next pass.
    """
    F = kp_data.shape[0]
    nq = q_init.shape[-1]
    if cfg.pose_mode == "lockstep":
        q0b = q_init if q_init.ndim == 2 else q_init.expand(F, nq)
        if cfg.root_kp_idx >= 0 and cfg.do_root_opt and root_reseed:
            root_xyz = kp_data[:, 3 * cfg.root_kp_idx : 3 * cfg.root_kp_idx + 3]
            q0b = torch.cat([root_xyz, q0b[:, 3:]], dim=1)
        qs_all = torch.ones(nq, dtype=torch.bool, device=kp_data.device)
        kps_to_opt = torch.ones(kp_data.shape[1], dtype=kp_data.dtype, device=kp_data.device)
        res = core.q_opt_batch(params, kp_data, qs_all, kps_to_opt, q0b, lb, ub, maxiter=maxiter)
        qposes = res.params
        if cfg.indiv_parts:
            qposes = _part_passes(core, cfg, params, kp_data, qposes, kps_to_opt, lb, ub)
        q_last = qposes[-1]
    else:
        q_last, qposes = _pose_sequential(core, cfg, params, kp_data[None], q_init[None], lb, ub)
        q_last, qposes = q_last[0], qposes[0]
    return (q_last, qposes) + _frame_outputs(core, params, kp_data, qposes)


def _frame_outputs(core, params, kp_data, qposes):
    """(xpos, xquat, marker_sites, errors) of poses (F, nq) against kp_data (F, 3K)."""
    fk_res = core.fk(params, qposes)
    marker_sites = fk_res.site_xpos[:, core.site_idxs_t]
    kp_xyz = kp_data.reshape(kp_data.shape[0], -1, 3)
    errors = torch.linalg.norm(kp_xyz - marker_sites, dim=-1).mean(dim=-1)
    return fk_res.xpos, fk_res.xquat, marker_sites, errors


# -------------------------------------------------------------- offset phase


def offset_optimization(
    core: StacCore,
    cfg: StacConfigStatic,
    params: KinParams,
    kp_data: torch.Tensor,
    offsets_prev: torch.Tensor,
    qposes: torch.Tensor,
    is_regularized: torch.Tensor,
    sample_idx: np.ndarray | None = None,
    group=None,
):
    """Closed-form m-phase on sampled frames; writes the offsets into the model.

    The sample is the first n_sample_frames of the JAX package's
    ``jax.random.permutation(PRNGKey(0), arange(F), independent=True)``,
    reproduced bit for bit by ``utils.prng``; ``sample_idx`` overrides it.
    The regularization target is the previous offsets.

    With a process ``group`` of more than one rank (the frame-sharded fit;
    kp_data and qposes are this rank's frames), each rank samples
    ceil(n_sample_frames / ranks) of its frames with ``PRNGKey(0)`` folded
    with its rank, and the m-solve's statistics are all-reduced over the
    group, the frame count being that sample times the ranks: the JAX
    package's sharded branch, whose sample deliberately differs from the
    single-program one (a mean estimator either way).
    """
    n_frames = kp_data.shape[0]
    n_shards = 1 if group is None else dist.get_world_size(group)
    n_total = None
    if sample_idx is None:
        key = prng.key_from_seed(0)
        n_sample = min(cfg.n_sample_frames, n_frames)
        if n_shards > 1:
            n_sample = min(-(-cfg.n_sample_frames // n_shards), n_frames)
            key = prng.fold_in(key, dist.get_rank(group))
            n_total = n_sample * n_shards
        sample_idx = prng.permutation(n_frames, key=key)[:n_sample]
    idx = torch.as_tensor(np.array(sample_idx, np.int64), device=kp_data.device)
    res = core.m_opt(
        params, kp_data[idx], qposes[idx], offsets_prev, is_regularized, cfg.m_reg_coef,
        n_frames_total=n_total, group=group,
    )
    new_params = params.set_site_pos(res.params, core.site_idxs_t)
    return new_params, res.params, res.error


# ------------------------------------------------------------- full programs


def fit_offsets_program(
    core: StacCore,
    cfg: StacConfigStatic,
    params: KinParams,
    kp_data: torch.Tensor,
    lb: torch.Tensor,
    ub: torch.Tensor,
    is_regularized: torch.Tensor,
    return_full: bool = True,
    group=None,
) -> dict:
    """The alternating calibration: root solve on frame 0, then n_iters x
    (pose pass, m-phase), then a final pose pass.

    With ``group`` (a torch.distributed group), kp_data is this rank's block
    of frames and the fit is the JAX package's ``fit_offsets_sharded``
    schedule on one shard: the root solve on the shard's first frame, the
    lockstep pose passes on its frames, and the m-phase with its statistics
    all-reduced over the group (the JAX ``psum``; see
    ``offset_optimization`` for the sample). Over one rank it is the
    unsharded fit exactly. Raises ValueError unless lockstep: the
    sequential warm-start chain is a cross-frame dependency that cannot
    shard over frames.

    Each pass starts from the LAST frame's pose of the pass before (the
    root solve's pose for the first): the sequential chain's frame 0 starts
    there, lockstep broadcasts it to every frame (root xyz re-anchored on
    each frame's keypoint). With fit_warm_iters (lockstep), passes after the
    first start every frame from its own previous solution instead, at that
    budget. As the JAX program does.
    """
    lockstep = cfg.pose_mode == "lockstep"
    if group is not None and not lockstep:
        raise ValueError("a fit sharded over frames requires pose_mode=lockstep")
    site_idxs = core.site_idxs_t
    q = params.qpos0
    offsets = params.site_pos[site_idxs]

    if cfg.do_root_opt and cfg.root_kp_idx >= 0:
        q = root_optimization(core, cfg, params, kp_data[0], q, lb, ub)

    warm_iters = cfg.fit_warm_iters if cfg.fit_warm_iters > 0 else None
    frame_errors, m_errors = [], []
    q_warm = None
    for _ in range(cfg.n_iters):
        q_init = q_warm if q_warm is not None else q
        mi = warm_iters if q_warm is not None else None
        q, qposes, _, _, _, errors = pose_optimization(
            core, cfg, params, kp_data, q_init, lb, ub, maxiter=mi
        )
        q_warm = qposes if (lockstep and warm_iters is not None) else None
        params, offsets, m_err = offset_optimization(
            core, cfg, params, kp_data, offsets, qposes, is_regularized, group=group
        )
        frame_errors.append(errors)
        m_errors.append(m_err)

    q_init = q_warm if q_warm is not None else q
    mi = warm_iters if q_warm is not None else None
    _, qposes, xposes, xquats, marker_sites, errors = pose_optimization(
        core, cfg, params, kp_data, q_init, lb, ub, maxiter=mi
    )
    F = kp_data.shape[0]
    out = {
        "qpos": qposes,
        "offsets": offsets,
        "frame_error": errors,
        "iter_frame_errors": (
            torch.stack(frame_errors) if frame_errors else kp_data.new_zeros((0, F))
        ),
        "iter_m_errors": torch.stack(m_errors) if m_errors else kp_data.new_zeros((0,)),
    }
    if return_full:
        out.update(xpos=xposes, xquat=xquats, marker_sites=marker_sites)
    return out


def ik_only_program(
    core: StacCore,
    cfg: StacConfigStatic,
    params: KinParams,
    batched_kp: torch.Tensor,
    offsets: torch.Tensor,
    lb: torch.Tensor,
    ub: torch.Tensor,
    return_full: bool = True,
):
    """IK with frozen offsets over clips batched_kp (C, Fc, 3K).

    sequential: each clip's root solve (single-frame solver) and its
    frame-by-frame chain, the C clips side by side on the lanes (the JAX
    per-clip vmap). lockstep: the per-clip root solves batch across clips
    and every frame then starts from its clip's root solution, as one flat
    batch. Hierarchical (lockstep gn-lm, hier_stride > 1): every s-th frame
    is solved cold at the full budget with its root xyz re-anchored on the
    keypoint, the other frames are seeded by ``interp_seeds``, and all
    frames are refined in hier_fine_iters (6 if 0) keeping the interpolated
    root translation. Returns (qpos, errors) or, with return_full,
    (qpos, xpos, xquat, marker_sites, errors), each shaped (C, Fc, ...).
    """
    params = params.set_site_pos(offsets, core.site_idxs_t)
    C, Fc = batched_kp.shape[0], batched_kp.shape[1]
    nq = params.qpos0.shape[-1]
    q_start = params.qpos0.expand(C, nq)

    def shape(a):
        return a.reshape(C, Fc, *a.shape[1:])

    if cfg.pose_mode != "lockstep":
        q = q_start
        if cfg.do_root_opt and cfg.root_kp_idx >= 0:
            q = root_optimization(core, cfg, params, batched_kp[:, 0], q, lb, ub)
        _, qposes = _pose_sequential(core, cfg, params, batched_kp, q, lb, ub)
        qposes = qposes.reshape(C * Fc, nq)
        outs = _frame_outputs(core, params, batched_kp.reshape(C * Fc, -1), qposes)
        if not return_full:
            return shape(qposes), shape(outs[-1])
        return (shape(qposes),) + tuple(shape(a) for a in outs)

    if cfg.do_root_opt and cfg.root_kp_idx >= 0:
        roots = root_optimization_batch(core, cfg, params, batched_kp[:, 0], q_start, lb, ub)
    else:
        roots = q_start
    kp_flat = batched_kp.reshape(C * Fc, -1)
    use_hier = cfg.hier_stride > 1 and core.q_solver == "gn-lm"
    fine_iters = None
    if use_hier:
        s_h = int(cfg.hier_stride)
        idx_c = np.arange(0, Fc, s_h)
        kp_c = batched_kp[:, idx_c].reshape(C * len(idx_c), -1)
        q0_c = torch.repeat_interleave(roots, len(idx_c), dim=0)
        if cfg.root_kp_idx >= 0 and cfg.do_root_opt:
            root_xyz_c = kp_c[:, 3 * cfg.root_kp_idx : 3 * cfg.root_kp_idx + 3]
            q0_c = torch.cat([root_xyz_c, q0_c[:, 3:]], dim=1)
        res_c = core.q_opt_batch(
            params,
            kp_c,
            torch.ones(nq, dtype=torch.bool, device=kp_c.device),
            torch.ones(kp_c.shape[1], dtype=kp_c.dtype, device=kp_c.device),
            q0_c,
            lb,
            ub,
        )
        q_coarse = res_c.params.reshape(C, len(idx_c), nq)
        q0_flat = interp_seeds(core.topo, q_coarse, s_h, Fc).reshape(C * Fc, nq)
        fine_iters = cfg.hier_fine_iters if cfg.hier_fine_iters > 0 else 6
    else:
        q0_flat = torch.repeat_interleave(roots, Fc, dim=0)
    _, qposes, xposes, xquats, marker_sites, errors = pose_optimization(
        core, cfg, params, kp_flat, q0_flat, lb, ub, maxiter=fine_iters,
        root_reseed=not use_hier,
    )
    if not return_full:
        return shape(qposes), shape(errors)
    return shape(qposes), shape(xposes), shape(xquats), shape(marker_sites), shape(errors)
