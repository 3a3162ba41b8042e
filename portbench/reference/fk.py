"""Plain forward kinematics (MuJoCo's ``mj_kinematics`` semantics), batched
over frames in plain PyTorch, one body at a time in tree order.

A free joint sets the body's frame from qpos (its quaternion normalised); a
ball joint turns the body about its anchor by its normalised quaternion; a
hinge by the angle (q - qpos0) about its axis; a slide moves the body along
its world axis by (q - qpos0). Each body's quaternion is normalised before
its children and sites use it. Quaternions are [w, x, y, z].
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.model import BALL, FREE, SLIDE, Model

_MINVAL = 1e-15  # mujoco's mjMINVAL: a shorter quaternion becomes the identity


def qmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def qrot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R(q) v."""
    w, u = q[..., :1], q[..., 1:]
    u, v = torch.broadcast_tensors(u, v)
    uv = torch.linalg.cross(u, v, dim=-1)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv, dim=-1))


def qnormalize(q: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    unit = torch.zeros_like(q)
    unit[..., 0] = 1.0
    return torch.where(n < _MINVAL, unit, q / torch.clamp(n, min=_MINVAL))


def qmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrices of unit quaternions."""
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    return torch.stack([qrot(q, eye[i].expand(q.shape[:-1] + (3,))) for i in range(3)], dim=-1)


class FK:
    """``fk(qpos (F, nq), offsets (K, 3) | None)``: world frames of a batch of
    poses, in the dtype of ``qpos``. ``offsets`` replaces the keypoint sites'
    positions in their bodies (the model's own where None)."""

    def __init__(self, model: Model, device, dtype=torch.float64):
        self.m = model
        self.device = torch.device(device)
        self.dtype = dtype
        t = lambda a: torch.as_tensor(np.asarray(a), device=self.device, dtype=dtype)  # noqa: E731
        self.body_pos, self.body_quat = t(model.body_pos), t(model.body_quat)
        self.jnt_pos, self.jnt_axis = t(model.jnt_pos), t(model.jnt_axis)
        self.qpos0, self.site_pos = t(model.qpos0), t(model.site_pos)
        i = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=self.device)  # noqa: E731
        self.site_idxs, self.site_body = i(model.site_idxs), i(model.site_bodyid)

    def frames(self, qpos: torch.Tensor) -> dict:
        """{"xpos" (F, nbody, 3), "xquat" (F, nbody, 4), "xanchor" and
        "xaxis" (F, njnt, 3)}: body frames and joint anchors and axes in the
        world (a free joint: its qpos translation and its local axis)."""
        m, F = self.m, qpos.shape[0]
        dt = qpos.dtype
        cast = lambda x: x.to(dt)  # noqa: E731
        xpos = [torch.zeros(F, 3, dtype=dt, device=qpos.device)]
        world = torch.zeros(F, 4, dtype=dt, device=qpos.device)
        world[:, 0] = 1.0
        xquat = [world]
        anchors, axes = {}, {}
        for b in range(1, m.nbody):
            p = int(m.parent[b])
            pos = xpos[p] + qrot(xquat[p], cast(self.body_pos[b]))
            quat = qmul(xquat[p], cast(self.body_quat[b]).expand(F, 4))
            for j in m.body_joints[b]:
                jt, qa = int(m.jnt_type[j]), int(m.jnt_qposadr[j])
                jpos, axis = cast(self.jnt_pos[j]), cast(self.jnt_axis[j])
                if jt == FREE:
                    pos = qpos[:, qa : qa + 3]
                    quat = qnormalize(qpos[:, qa + 3 : qa + 7])
                    anchors[j], axes[j] = pos, axis.expand(F, 3)
                    continue
                anchor = pos + qrot(quat, jpos)
                axis_w = qrot(quat, axis)
                anchors[j], axes[j] = anchor, axis_w
                if jt == SLIDE:
                    pos = pos + axis_w * (qpos[:, qa : qa + 1] - cast(self.qpos0[qa]))
                    continue
                if jt == BALL:
                    local = qnormalize(qpos[:, qa : qa + 4])
                else:  # HINGE
                    half = 0.5 * (qpos[:, qa] - cast(self.qpos0[qa]))
                    local = torch.cat([torch.cos(half)[:, None], torch.sin(half)[:, None] * axis], dim=-1)
                quat = qmul(quat, local)
                pos = anchor - qrot(quat, jpos)
            xpos.append(pos)
            xquat.append(qnormalize(quat))
        njnt = len(m.jnt_type)
        return {
            "xpos": torch.stack(xpos, dim=1),
            "xquat": torch.stack(xquat, dim=1),
            "xanchor": torch.stack([anchors[j] for j in range(njnt)], dim=1),
            "xaxis": torch.stack([axes[j] for j in range(njnt)], dim=1),
        }

    def site_positions(self, fr: dict, offsets: torch.Tensor | None = None) -> torch.Tensor:
        """(F, nsite, 3) every site in the world; keypoint sites at ``offsets``."""
        site_pos = self.site_pos.to(fr["xpos"].dtype)
        if offsets is not None:
            site_pos = site_pos.index_put((self.site_idxs,), offsets.to(site_pos.dtype))
        return fr["xpos"][:, self.site_body] + qrot(fr["xquat"][:, self.site_body], site_pos)

    def markers(self, qpos: torch.Tensor, offsets: torch.Tensor | None = None) -> torch.Tensor:
        """(F, K, 3) the keypoint sites in the world, in keypoint order."""
        return self.site_positions(self.frames(qpos), offsets)[:, self.site_idxs]


def marker_residuals(fk: FK, qpos, offsets, keypoints, markers=None, block: int = 65536):
    """(F, K) |marker - keypoint| in metres, in float64, ``block`` frames at a
    time: qpos (F, nq), offsets (K, 3), keypoints (F, 3K), each a numpy array
    or a tensor. With ``markers`` (F, K, 3), another's marker positions for
    the same poses, also returns the largest |markers - the reference's|."""
    dev = fk.device
    off = torch.as_tensor(offsets, device=dev).to(torch.float64)
    out, gap = [], 0.0
    for s in range(0, len(qpos), block):
        q = torch.as_tensor(qpos[s : s + block], device=dev).to(torch.float64)
        kp = torch.as_tensor(keypoints[s : s + block], device=dev).to(torch.float64)
        mk = fk.markers(q, off)
        out.append(torch.linalg.vector_norm(mk - kp.reshape(q.shape[0], -1, 3), dim=-1))
        if markers is not None:
            theirs = torch.as_tensor(markers[s : s + block], device=dev).to(torch.float64)
            gap = max(gap, float((theirs.reshape(mk.shape) - mk).abs().max()))
    r = torch.cat(out)
    return r if markers is None else (r, gap)
