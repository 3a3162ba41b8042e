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


def take(x: torch.Tensor, dim: int, index: torch.Tensor) -> torch.Tensor:
    """``x`` indexed along ``dim`` by an integer tensor of any shape, as
    ``index_select`` (whose gradient is one ``index_add``; advanced indexing's
    is an accumulating ``index_put``, several kernels on a GPU)."""
    dim = dim % x.ndim
    out = x.index_select(dim, index.reshape(-1))
    return out.reshape(x.shape[:dim] + index.shape + x.shape[dim + 1 :])


# Hamilton product as out[r] = sum_t sign[r, t] * q1[t] * q2[src[r, t]], the
# terms in the order of w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2 etc.
_MUL_SRC = ((0, 1, 2, 3), (1, 0, 3, 2), (2, 3, 0, 1), (3, 2, 1, 0))
_MUL_SIGN = ((1, -1, -1, -1), (1, 1, 1, -1), (1, -1, 1, 1), (1, 1, -1, 1))
_CONSTANTS: dict = {}


def _constants(like: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(product source indices, product signs, unit quaternion) on like's device and dtype."""
    key = (like.device, like.dtype)
    if key not in _CONSTANTS:
        _CONSTANTS[key] = (
            torch.tensor(_MUL_SRC, device=like.device),
            torch.tensor(_MUL_SIGN, dtype=like.dtype, device=like.device),
            torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=like.dtype, device=like.device),
        )
    return _CONSTANTS[key]


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 * q2, as one gathered 4x4 product per pair (a few
    batched ops, forward and backward, instead of 28 scalar ones)."""
    src, sign, _ = _constants(q2)
    p = q1[..., None, :] * sign * take(q2, -1, src)
    # Summed left to right: the roundings of the scalar formula.
    return p[..., 0] + p[..., 1] + p[..., 2] + p[..., 3]


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
    if u.ndim != v.ndim:  # linalg.cross broadcasts only between equal ranks
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
    safe_norm = torch.sqrt(norm2.masked_fill(bad, 1.0))
    return torch.where(bad, _constants(q)[2], q / safe_norm)


def axis_angle_quat(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Quaternion from unit axis (..., 3) and angle (...,) (mju_axisAngle2Quat)."""
    half = (0.5 * angle)[..., None]
    vec = axis * torch.sin(half)
    return torch.cat([torch.cos(half).expand(vec.shape[:-1] + (1,)), vec], dim=-1)


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
