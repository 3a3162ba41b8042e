"""Forward kinematics over batched tensors (port of ``stac_mjx_tpu/models/kinematics.py``).

Only the pointer-doubling FK (``make_fk_jump``) is ported: it is the one the
lockstep Gauss-Newton path runs. Numerical semantics match MuJoCo's
``mj_kinematics``: free joints set the frame from qpos (mju_normalize4),
ball/hinge/slide compose about the joint anchor with displacements relative
to ``qpos0``, and the final body quaternion is normalized before the site
frames are computed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from stac_mjx_tpu_torch.ops import quat as qm

# Joint type codes (mujoco.mjtJoint order: FREE=0, BALL=1, SLIDE=2, HINGE=3).
JNT_FREE = 0
JNT_BALL = 1
JNT_SLIDE = 2
JNT_HINGE = 3
JNT_NONE = 4  # padding


class KinTopology:
    """Static description of the kinematic tree (host-side numpy).

    Same constructor and fields as the JAX package's ``KinTopology``, minus
    the per-level tables of its level-scan FK, which the port does not have.
    """

    def __init__(
        self,
        *,
        nq: int,
        nv: int,
        nbody: int,
        nsite: int,
        njnt: int,
        body_parentid: np.ndarray,
        body_jntadr: np.ndarray,
        body_jntnum: np.ndarray,
        jnt_type: np.ndarray,
        jnt_qposadr: np.ndarray,
        jnt_bodyid: np.ndarray,
        site_bodyid: np.ndarray,
        body_names: list[str],
        jnt_names: list[str],
        site_names: list[str],
    ):
        self.nq = int(nq)
        self.nv = int(nv)
        self.nbody = int(nbody)
        self.nsite = int(nsite)
        self.njnt = int(njnt)
        self.body_parentid = np.asarray(body_parentid, dtype=np.int32)
        self.body_jntadr = np.asarray(body_jntadr, dtype=np.int32)
        self.body_jntnum = np.asarray(body_jntnum, dtype=np.int32)
        self.jnt_type = np.asarray(jnt_type, dtype=np.int32)
        self.jnt_qposadr = np.asarray(jnt_qposadr, dtype=np.int32)
        self.jnt_bodyid = np.asarray(jnt_bodyid, dtype=np.int32)
        self.site_bodyid = np.asarray(site_bodyid, dtype=np.int32)
        self.body_names = list(body_names)
        self.jnt_names = list(jnt_names)
        self.site_names = list(site_names)

        # --- padded joint slots per body.
        self.max_slots = int(self.body_jntnum.max()) if self.njnt else 0
        ms = max(self.max_slots, 1)
        self.slot_jid = np.full((self.nbody, ms), -1, dtype=np.int32)
        self.slot_type = np.full((self.nbody, ms), JNT_NONE, dtype=np.int32)
        self.slot_qadr = np.zeros((self.nbody, ms), dtype=np.int32)
        for b in range(self.nbody):
            for s in range(int(self.body_jntnum[b])):
                j = int(self.body_jntadr[b]) + s
                self.slot_jid[b, s] = j
                self.slot_type[b, s] = int(self.jnt_type[j])
                self.slot_qadr[b, s] = int(self.jnt_qposadr[j])

        dof_per_type = {JNT_FREE: 6, JNT_BALL: 3, JNT_SLIDE: 1, JNT_HINGE: 1}
        self.jnt_dofnum = np.array(
            [dof_per_type[int(t)] for t in self.jnt_type], dtype=np.int32
        )

    def name2id(self, kind: str, name: str) -> int:
        table = {"body": self.body_names, "joint": self.jnt_names, "site": self.site_names}[kind]
        return table.index(name)


@dataclasses.dataclass(frozen=True)
class KinParams:
    """Model arrays as tensors on one device and dtype (unbatched)."""

    body_pos: torch.Tensor  # (nbody, 3)
    body_quat: torch.Tensor  # (nbody, 4)
    jnt_axis: torch.Tensor  # (njnt, 3)
    jnt_pos: torch.Tensor  # (njnt, 3)
    qpos0: torch.Tensor  # (nq,)
    site_pos: torch.Tensor  # (nsite, 3)
    site_quat: torch.Tensor  # (nsite, 4)

    def set_site_pos(self, offsets: torch.Tensor, site_idxs: torch.Tensor) -> "KinParams":
        """Copy with ``site_pos[site_idxs] = offsets`` (the m-phase update)."""
        site_pos = self.site_pos.index_put((site_idxs,), offsets.to(self.site_pos.dtype))
        return dataclasses.replace(self, site_pos=site_pos)


@dataclasses.dataclass(frozen=True)
class FKResult:
    """World frames from one batched FK pass; every field has a leading frame dim F."""

    xpos: torch.Tensor  # (F, nbody, 3) body frame origins
    xquat: torch.Tensor  # (F, nbody, 4) body orientations (normalized)
    site_xpos: torch.Tensor  # (F, nsite, 3) site world positions
    xanchor: torch.Tensor  # (F, njnt, 3) joint anchors in the world frame
    xaxis: torch.Tensor  # (F, njnt, 3) joint axes in the world frame

    def xmat(self) -> torch.Tensor:
        """(F, nbody, 3, 3) rotation matrices."""
        return qm.quat_to_mat(self.xquat)

    def where(self, ok: torch.Tensor, other: "FKResult") -> "FKResult":
        """Per-frame select: ``self`` where ok (F,) is true, else ``other``."""
        m = ok[:, None, None]
        return FKResult(
            **{
                f.name: torch.where(m, getattr(self, f.name), getattr(other, f.name))
                for f in dataclasses.fields(self)
            }
        )


def make_fk_jump(topo: KinTopology, device: torch.device | str):
    """Pointer-doubling FK: ``fk(params, qpos (F, nq)) -> FKResult``.

    1. Local pass, parallel over bodies: each body's transform relative to
       its parent (body offset composed with its joint slots), plus every
       joint's anchor/axis in the parent frame. Each slot pays only for the
       joint types it contains (static pruning).
    2. Doubling pass: ``T[b] <- T[P[b]] . T[b]; P <- P[P]``, ceil(log2(depth))
       times, composes every chain to the world frame. Free-jointed bodies
       take their world frame straight from qpos, so their pointer is the
       world body.

    qpos reads are index gathers (the JAX version's one-hot matvecs were a
    TPU layout trick). All index tables live on ``device``.
    """
    nq = topo.nq
    S = max(topo.max_slots, 1)

    def idx(a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

    def mask(a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=bool), device=device)[:, None]

    slots = []
    for s in range(topo.max_slots):
        jtype = topo.slot_type[:, s]
        qadr = np.minimum(topo.slot_qadr[:, s], nq - 1)
        present = {int(t) for t in jtype} - {JNT_NONE}
        slots.append(
            dict(
                jid=idx(np.maximum(topo.slot_jid[:, s], 0)),
                q1=idx(qadr),
                qv7=idx(np.minimum(topo.slot_qadr[:, s][:, None] + np.arange(7), nq - 1)),
                free=JNT_FREE in present,
                ball=JNT_BALL in present,
                hinge=JNT_HINGE in present,
                slide=JNT_SLIDE in present,
                is_free=mask(jtype == JNT_FREE),
                is_ball=mask(jtype == JNT_BALL),
                is_hinge=mask(jtype == JNT_HINGE),
                is_slide=mask(jtype == JNT_SLIDE),
            )
        )

    # Jump pointers: free-jointed bodies attach directly to the world.
    jump_parent = topo.body_parentid.copy()
    for b in range(topo.nbody):
        if topo.max_slots and topo.slot_type[b, 0] == JNT_FREE:
            jump_parent[b] = 0
    depth = np.zeros(topo.nbody, dtype=np.int64)
    for b in range(1, topo.nbody):
        depth[b] = depth[jump_parent[b]] + 1
    max_depth = int(depth.max()) if topo.nbody > 1 else 0
    n_jumps = int(np.ceil(np.log2(max_depth))) if max_depth > 1 else max_depth
    ptr_steps = []
    P = jump_parent.astype(np.int64)
    for _ in range(n_jumps):
        ptr_steps.append(idx(P))
        P = P[P]

    # (body, slot) -> joint: every joint sits in exactly one valid slot, so
    # the scatter to joint order is a gather by the inverse permutation.
    valid = (topo.slot_type != JNT_NONE).ravel()
    flat_idx = np.nonzero(valid)[0]
    flat_jid = topo.slot_jid.ravel()[flat_idx]
    inv = np.empty(len(flat_jid), np.int64)
    inv[flat_jid] = np.arange(len(flat_jid))
    jnt_flat = idx(flat_idx[inv])  # joint j's row in the (nbody*S) slot table
    jnt_parent = idx(topo.body_parentid[flat_idx[inv] // S])
    jnt_free = mask(topo.jnt_type == JNT_FREE)
    site_body = idx(topo.site_bodyid)

    def fk(params: KinParams, qpos: torch.Tensor) -> FKResult:
        F = qpos.shape[0]
        dtype = qpos.dtype
        t = params.body_pos.expand(F, -1, -1)
        q = params.body_quat.expand(F, -1, -1)
        anchors_p = []
        axes_p = []
        for sl in slots:
            axis = params.jnt_axis[sl["jid"]]
            jpos = params.jnt_pos[sl["jid"]]
            has_rel = sl["ball"] or sl["hinge"] or sl["slide"]
            if sl["free"] or sl["ball"]:
                qv7 = qpos[:, sl["qv7"]]  # (F, nbody, 7)
                q1 = qv7[..., 0]
            else:
                q1 = qpos[:, sl["q1"]]  # (F, nbody)
            if sl["hinge"] or sl["slide"]:
                dq = q1 - params.qpos0[sl["q1"]]
            if has_rel:
                anchor = t + qm.quat_rotate(q, jpos)
                axis_w = qm.quat_rotate(q, axis)
            # Disjoint static masks: each branch overwrites only its bodies.
            t_new, q_new = t, q
            if sl["slide"]:
                t_new = torch.where(sl["is_slide"], t + axis_w * dq[..., None], t_new)
            if sl["hinge"]:
                hinge_quat = qm.quat_mul(q, qm.axis_angle_quat(axis, dq))
                t_new = torch.where(sl["is_hinge"], anchor - qm.quat_rotate(hinge_quat, jpos), t_new)
                q_new = torch.where(sl["is_hinge"], hinge_quat, q_new)
            if sl["ball"]:
                ball_quat = qm.quat_mul(q, qm.quat_normalize(qv7[..., :4]))
                t_new = torch.where(sl["is_ball"], anchor - qm.quat_rotate(ball_quat, jpos), t_new)
                q_new = torch.where(sl["is_ball"], ball_quat, q_new)
            if sl["free"]:
                free_pos = qv7[..., :3]
                t_new = torch.where(sl["is_free"], free_pos, t_new)
                q_new = torch.where(sl["is_free"], qm.quat_normalize(qv7[..., 3:7]), q_new)
            anch = anchor if has_rel else t_new
            axw = axis_w if has_rel else axis.expand(F, -1, -1)
            if sl["free"]:
                anch = torch.where(sl["is_free"], free_pos, anch)
                axw = torch.where(sl["is_free"], axis, axw)
            anchors_p.append(anch)
            axes_p.append(axw)
            t, q = t_new, q_new

        # The world body stays the identity frame.
        t = torch.cat([torch.zeros_like(t[:, :1]), t[:, 1:]], dim=1)
        unit = torch.zeros_like(q[:, :1])
        unit[..., 0] = 1.0
        q = torch.cat([unit, q[:, 1:]], dim=1)

        for P_k in ptr_steps:
            t = t[:, P_k] + qm.quat_rotate(q[:, P_k], t)
            q = qm.quat_mul(q[:, P_k], q)

        xquat = qm.quat_normalize(q)
        xpos = t

        if topo.njnt and topo.max_slots:
            anch_ps = torch.stack(anchors_p, dim=2).reshape(F, -1, 3)[:, jnt_flat]
            axis_ps = torch.stack(axes_p, dim=2).reshape(F, -1, 3)[:, jnt_flat]
            pq = xquat[:, jnt_parent]
            pt = xpos[:, jnt_parent]
            xanchor = torch.where(jnt_free, anch_ps, pt + qm.quat_rotate(pq, anch_ps))
            xaxis = torch.where(jnt_free, axis_ps, qm.quat_rotate(pq, axis_ps))
        else:
            xanchor = xaxis = torch.zeros((F, 1, 3), dtype=dtype, device=qpos.device)

        site_xpos = xpos[:, site_body] + qm.quat_rotate(xquat[:, site_body], params.site_pos)
        return FKResult(xpos=xpos, xquat=xquat, site_xpos=site_xpos, xanchor=xanchor, xaxis=xaxis)

    return fk
