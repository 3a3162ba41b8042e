"""STAC drivers over batched tensors (port of ``stac_mjx_tpu/pipeline.py``, lockstep mode).

Lockstep scheduling solves every frame of a pass at once through the flat
LM: ``fit_offsets_program`` (root solve, N x (pose pass, m-phase), final
pose pass) and ``ik_only_program`` (per-clip root solves, then one flat
batch over every frame of every clip; optionally hierarchical: strided cold
solves, nlerp seeds, a short warm pass over all frames). The sequential
(parity) mode and the per-part refinement passes are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from stac_mjx_tpu_torch.models.kinematics import JNT_BALL, JNT_FREE, KinParams
from stac_mjx_tpu_torch.ops.stac_core import StacCore, make_qs
from stac_mjx_tpu_torch.utils import prng

_NOT_PORTED = "is not ported yet (ROADMAP.md, modules still open)"


@dataclasses.dataclass(frozen=True)
class StacConfigStatic:
    """Pipeline configuration; fields as in the JAX package's ``StacConfigStatic``."""

    n_iters: int
    n_sample_frames: int
    m_reg_coef: float
    root_kp_idx: int  # -1 => no root optimization
    root_dims: int  # 7 (free) or 4 (slide)
    do_root_opt: bool
    indiv_parts: tuple  # per-part qpos masks; must be empty here
    trunk_kps: Any  # np.ndarray bool (K,)
    pose_mode: str = "lockstep"
    root_opt_passes: int = 1
    hier_stride: int = 0
    hier_fine_iters: int = 0
    fit_warm_iters: int = 0


def _check(cfg: StacConfigStatic) -> None:
    if cfg.pose_mode != "lockstep":
        raise NotImplementedError(f"pose_mode={cfg.pose_mode!r} {_NOT_PORTED}")
    if cfg.indiv_parts:
        raise NotImplementedError(f"per-part refinement (skip_part_opt=false) {_NOT_PORTED}")


def _root_masks(cfg, q0):
    nq = q0.shape[-1]
    qs_to_opt = torch.zeros(nq, dtype=torch.bool, device=q0.device)
    qs_to_opt[: cfg.root_dims] = True
    kps = np.repeat(np.asarray(cfg.trunk_kps), 3)
    return qs_to_opt, torch.as_tensor(kps, device=q0.device).to(q0.dtype)


# ---------------------------------------------------------------- root phase


def root_optimization(core: StacCore, cfg, params, kp_frame, q0, lb, ub) -> torch.Tensor:
    """Root-only solves on one frame (kp_frame (3K,), q0 (nq,)), each pass
    seeded with the root keypoint's xyz, against the trunk keypoints only."""
    root_xyz = kp_frame[3 * cfg.root_kp_idx : 3 * cfg.root_kp_idx + 3]
    qs_to_opt, kps_to_opt = _root_masks(cfg, q0)
    q = q0
    for _ in range(cfg.root_opt_passes):
        q = torch.cat([root_xyz, q[3:]])
        res = core.q_opt(params, kp_frame, qs_to_opt, kps_to_opt, q, lb, ub)
        q = make_qs(q, qs_to_opt, res.params)
    return q


def root_optimization_batch(core: StacCore, cfg, params, kp_frames, q0, lb, ub) -> torch.Tensor:
    """root_optimization for C clips at once: kp_frames (C, 3K), q0 (C, nq)."""
    root_xyz = kp_frames[:, 3 * cfg.root_kp_idx : 3 * cfg.root_kp_idx + 3]
    qs_to_opt, kps_to_opt = _root_masks(cfg, q0)
    q = q0
    for _ in range(cfg.root_opt_passes):
        q = torch.cat([root_xyz, q[:, 3:]], dim=1)
        res = core.q_opt_batch(params, kp_frames, qs_to_opt, kps_to_opt, q, lb, ub)
        q = make_qs(q, qs_to_opt, res.params)
    return q


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
    """Lockstep pose pass: every frame solved at once from ``q_init``.

    q_init is (nq,), broadcast to every frame, or (F, nq). With root_reseed,
    each frame's root xyz starts at its own root keypoint.

    Returns (q_last, qposes (F, nq), xpos, xquat, marker_sites, errors (F,)),
    errors being the per-frame mean marker distance in meters. q_last is the
    LAST frame's pose, the carry the fit hands to its next pass.
    """
    _check(cfg)
    F = kp_data.shape[0]
    nq = q_init.shape[-1]
    q0b = q_init if q_init.ndim == 2 else q_init.expand(F, nq)
    if cfg.root_kp_idx >= 0 and cfg.do_root_opt and root_reseed:
        root_xyz = kp_data[:, 3 * cfg.root_kp_idx : 3 * cfg.root_kp_idx + 3]
        q0b = torch.cat([root_xyz, q0b[:, 3:]], dim=1)
    qs_all = torch.ones(nq, dtype=torch.bool, device=kp_data.device)
    kps_to_opt = torch.ones(kp_data.shape[1], dtype=kp_data.dtype, device=kp_data.device)
    res = core.q_opt_batch(params, kp_data, qs_all, kps_to_opt, q0b, lb, ub, maxiter=maxiter)
    qposes = res.params
    q_last = qposes[-1]

    fk_res = core.fk(params, qposes)
    marker_sites = fk_res.site_xpos[:, core.site_idxs_t]
    kp_xyz = kp_data.reshape(F, -1, 3)
    errors = torch.linalg.norm(kp_xyz - marker_sites, dim=-1).mean(dim=-1)
    return q_last, qposes, fk_res.xpos, fk_res.xquat, marker_sites, errors


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
):
    """Closed-form m-phase on sampled frames; writes the offsets into the model.

    The sample is the first n_sample_frames of the JAX package's
    ``jax.random.permutation(PRNGKey(0), arange(F), independent=True)``,
    reproduced bit for bit by ``utils.prng``; ``sample_idx`` overrides it.
    The regularization target is the previous offsets.
    """
    n_frames = kp_data.shape[0]
    if sample_idx is None:
        sample_idx = prng.permutation(n_frames)[: min(cfg.n_sample_frames, n_frames)]
    idx = torch.as_tensor(np.array(sample_idx, np.int64), device=kp_data.device)
    res = core.m_opt(
        params, kp_data[idx], qposes[idx], offsets_prev, is_regularized, cfg.m_reg_coef
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
) -> dict:
    """The alternating calibration: root solve on frame 0, then n_iters x
    (pose pass, m-phase), then a final pose pass.

    Without fit_warm_iters, pass k+1 starts every frame from the LAST
    frame's pose of pass k (root xyz re-anchored on each frame's keypoint),
    as the JAX program does.
    """
    _check(cfg)
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
        q_warm = qposes if warm_iters is not None else None
        params, offsets, m_err = offset_optimization(
            core, cfg, params, kp_data, offsets, qposes, is_regularized
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
    """IK with frozen offsets over clips batched_kp (C, Fc, 3K), as one flat batch.

    Per-clip root solves batch across clips; every frame then starts from
    its clip's root solution. Hierarchical (hier_stride > 1): every s-th
    frame is solved cold at the full budget with its root xyz re-anchored on
    the keypoint, the other frames are seeded by ``interp_seeds``, and all
    frames are refined in hier_fine_iters (6 if 0) keeping the interpolated
    root translation. Returns (qpos, errors) or, with return_full,
    (qpos, xpos, xquat, marker_sites, errors), each shaped (C, Fc, ...).
    """
    _check(cfg)
    params = params.set_site_pos(offsets, core.site_idxs_t)
    C, Fc = batched_kp.shape[0], batched_kp.shape[1]
    nq = params.qpos0.shape[-1]
    q_start = params.qpos0.expand(C, nq)
    if cfg.do_root_opt and cfg.root_kp_idx >= 0:
        roots = root_optimization_batch(core, cfg, params, batched_kp[:, 0], q_start, lb, ub)
    else:
        roots = q_start
    kp_flat = batched_kp.reshape(C * Fc, -1)
    use_hier = cfg.hier_stride > 1
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

    def shape(a):
        return a.reshape(C, Fc, *a.shape[1:])

    if not return_full:
        return shape(qposes), shape(errors)
    return shape(qposes), shape(xposes), shape(xquats), shape(marker_sites), shape(errors)
