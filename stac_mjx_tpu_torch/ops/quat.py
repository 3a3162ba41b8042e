"""Batched quaternion math (port of ``stac_mjx_tpu/ops/quat.py``).

Every function takes arbitrary leading batch dims. Conventions follow MuJoCo:
quaternions are [w, x, y, z], rotations are active,
``quat_rotate(q, v) = R(q) @ v``.
"""

from __future__ import annotations

import math

import torch

# MuJoCo's mjMINVAL, used by mju_normalize4 to guard degenerate quaternions.
_MJ_MINVAL = 1e-15
# Tolerance used when converting quaternions to axis-angle near the identity.
_TOL = 1e-10


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 * q2."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    """Quaternion conjugate [w, -x, -y, -z]."""
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_diff(source: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Quaternion taking ``source`` to ``target``: conj(source) * target."""
    return quat_mul(quat_conj(source), target)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by quaternion(s) q: v + 2 (w (u x v) + u x (u x v))."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    u, v = torch.broadcast_tensors(u, v)
    uv = torch.linalg.cross(u, v, dim=-1)
    uuv = torch.linalg.cross(u, uv, dim=-1)
    return v + 2.0 * (w * uv + uuv)


def quat_rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by the inverse of q."""
    return quat_rotate(quat_conj(q), v)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    """Normalize with mju_normalize4 semantics: a norm below mjMINVAL gives [1, 0, 0, 0]."""
    norm2 = torch.sum(q * q, dim=-1, keepdim=True)
    bad = norm2 < _MJ_MINVAL * _MJ_MINVAL
    safe_norm = torch.sqrt(torch.where(bad, torch.ones_like(norm2), norm2))
    unit = torch.zeros_like(q)
    unit[..., 0] = 1.0
    return torch.where(bad, unit, q / safe_norm)


def axis_angle_quat(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Quaternion from unit axis (..., 3) and angle (...,) (mju_axisAngle2Quat)."""
    half = 0.5 * angle
    s = torch.sin(half)
    axis, s = torch.broadcast_tensors(axis, s[..., None])
    return torch.cat([torch.cos(half)[..., None].expand(s.shape[:-1] + (1,)), axis * s], dim=-1)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrix from quaternion: (..., 4) -> (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    r = torch.stack(
        [
            1 - 2 * (y * y + z * z),
            2 * (x * y - w * z),
            2 * (x * z + w * y),
            2 * (x * y + w * z),
            1 - 2 * (x * x + z * z),
            2 * (y * z - w * x),
            2 * (x * z - w * y),
            2 * (y * z + w * x),
            1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return r.reshape(r.shape[:-1] + (3, 3))


def quat_to_axisangle(quat: torch.Tensor) -> torch.Tensor:
    """Axis-angle with the angle as the vector's length, wrapped to (-pi, pi].

    Near-identity rotations return zeros; an exactly-pi rotation keeps +pi
    (the reference wraps only angle > pi strictly).
    """
    w = torch.clamp(quat[..., 0], -1.0, 1.0)
    angle = 2.0 * torch.arccos(w)
    small = angle < _TOL
    qn = torch.sin(angle / 2.0)
    safe_qn = torch.where(small, torch.ones_like(qn), qn)
    wrapped = torch.where(angle > math.pi, angle - 2.0 * math.pi, angle)
    out = quat[..., 1:4] / safe_qn[..., None] * wrapped[..., None]
    return torch.where(small[..., None], torch.zeros_like(out), out)


def quat_exp(v: torch.Tensor) -> torch.Tensor:
    """Quaternion exponential of a rotation vector, with a small-angle series
    (port of ``stac_mjx_tpu/ops/gn_ik.py::quat_exp``)."""
    angle2 = torch.sum(v * v, dim=-1, keepdim=True)
    angle = torch.sqrt(torch.clamp(angle2, min=1e-24))
    half = 0.5 * angle
    s = torch.where(angle2 > 1e-16, torch.sin(half) / angle, 0.5 - angle2 / 48.0)
    return torch.cat([torch.cos(half), v * s], dim=-1)
