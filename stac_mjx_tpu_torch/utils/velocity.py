"""Velocity inference from fitted qpos trajectories (port of
``stac_mjx_tpu/utils/velocity.py``), in torch on the caller's device."""

from __future__ import annotations

import torch

from stac_mjx_tpu_torch.ops import quat as qm


def compute_velocity_from_kinematics(
    qpos_trajectory: torch.Tensor,
    dt: float,
    freejoint: bool = True,
    max_qvel: float = 20.0,
) -> torch.Tensor:
    """Finite-difference qvel from a qpos trajectory (..., T, nq).

    Any leading dims are clips: one call over (n_clips, T, nq) does what the
    JAX package's ``jax.vmap`` over clips does. The last frame is repeated so
    the output has T frames. With a free joint the columns are the root
    translation, the angular velocity from the normalised quaternion
    difference through axis-angle, then the raw differences of qpos[7:] (so
    nq - 1 columns where ball joints hold quaternions, the reference's
    layout), and only columns 6 and up are clipped to +-max_qvel.
    """
    q = torch.cat([qpos_trajectory, qpos_trajectory[..., -1:, :]], dim=-2)
    if not freejoint:
        return torch.clamp((q[..., 1:, :] - q[..., :-1, :]) / dt, -max_qvel, max_qvel)

    qvel_joints = (q[..., 1:, 7:] - q[..., :-1, 7:]) / dt
    qvel_translation = (q[..., 1:, :3] - q[..., :-1, :3]) / dt
    diff = qm.quat_diff(q[..., :-1, 3:7], q[..., 1:, 3:7])
    diff = diff / torch.linalg.norm(diff, dim=-1, keepdim=True)
    qvel_gyro = qm.quat_to_axisangle(diff) / dt
    return torch.cat(
        [qvel_translation, qvel_gyro, torch.clamp(qvel_joints, -max_qvel, max_qvel)], dim=-1
    )
