"""Forward kinematics over batched tensors (port of ``stac_mjx_tpu/models/kinematics.py``).

Both schedules are here: the level scan (``make_fk``, the ``fk_impl=scan``
default) and pointer doubling (``make_fk_jump``); also the FK of a subset of
sites (``make_site_fk``) and the subtree centres of mass (``subtree_com``,
mjx's ``com_pos``). Numerical semantics match
MuJoCo's ``mj_kinematics``: free joints set the frame from qpos
(mju_normalize4), ball/hinge/slide compose about the joint anchor with
displacements relative to ``qpos0``, and the final body quaternion is
normalized before the site frames are computed. Every write is out of place,
so ``torch.autograd`` differentiates through either FK (the
projected-gradient solvers do).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from stac_mjx_tpu_torch.ops import quat as qm
from stac_mjx_tpu_torch.utils.profiling import annotate

# Joint type codes (mujoco.mjtJoint order: FREE=0, BALL=1, SLIDE=2, HINGE=3).
JNT_FREE = 0
JNT_BALL = 1
JNT_SLIDE = 2
JNT_HINGE = 3
JNT_NONE = 4  # padding


class KinTopology:
    """Static description of the kinematic tree (host-side numpy).

    Same constructor and fields as the JAX package's ``KinTopology``,
    including the per-level tables of the level-scan FK.
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

        # --- depth levels: bodies grouped so every parent is in a prior level.
        depth = np.zeros(self.nbody, dtype=np.int32)
        for b in range(1, self.nbody):
            depth[b] = depth[self.body_parentid[b]] + 1
        self.levels: list[np.ndarray] = [
            np.nonzero(depth == d)[0].astype(np.int32)
            for d in range(1, int(depth.max()) + 1 if self.nbody > 1 else 1)
        ]

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

        # --- padded per-level tables (as in the JAX package; padding rows
        # point at body 0). ``make_fk`` reads each level's real rows only.
        self.n_levels = len(self.levels)
        self.level_pad = max((len(lv) for lv in self.levels), default=1)
        L, P, S = self.n_levels, self.level_pad, ms
        self.lv_body = np.zeros((L, P), dtype=np.int32)
        self.lv_parent = np.zeros((L, P), dtype=np.int32)
        self.lv_jid = np.zeros((L, P, S), dtype=np.int32)  # clamped; NONE-typed
        self.lv_jtype = np.full((L, P, S), JNT_NONE, dtype=np.int32)
        self.lv_qadr = np.zeros((L, P, S), dtype=np.int32)
        for li, lvl in enumerate(self.levels):
            n = len(lvl)
            self.lv_body[li, :n] = lvl
            self.lv_parent[li, :n] = self.body_parentid[lvl]
            self.lv_jid[li, :n] = np.maximum(self.slot_jid[lvl], 0)
            self.lv_jtype[li, :n] = self.slot_type[lvl]
            self.lv_qadr[li, :n] = self.slot_qadr[lvl]
        # (level, lane, slot) -> joint id, valid slots only.
        valid = (self.lv_jtype != JNT_NONE).ravel()
        self.slot_flat_idx = np.nonzero(valid)[0].astype(np.int32)
        self.slot_flat_jid = self.lv_jid.ravel()[self.slot_flat_idx]

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


def _spanned(fk):
    """``fk`` with each pass in a span ``fk`` (``profiling.annotate``)."""

    def spanned(params: KinParams, qpos: torch.Tensor) -> FKResult:
        with annotate("fk"):
            return fk(params, qpos)

    return spanned


def make_fk(topo: KinTopology, device: torch.device | str):
    """Level-scan FK: ``fk(params, qpos (F, nq)) -> FKResult``.

    A Python loop over depth levels; each level is one batched op over
    (frames x bodies in the level) per joint slot: the parent frame composed
    with the body offset, then each slot's joint about its anchor. The JAX
    version scans a padded level width and lets the padding lanes rewrite
    body 0; here each level takes its real bodies only and writes them with
    an out-of-place ``index_copy``, so autograd sees every write. The joint
    types a (level, slot) holds are known on the host, so only those
    branches are computed (the selects are disjoint, as in the JAX version).
    """
    nq = topo.nq
    n7 = np.arange(7)

    def idx(a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

    def lane_mask(mask: np.ndarray):
        """A (level, slot)'s lanes of one joint type: True or False when
        uniform (the select is then skipped), else a (n, 1) tensor."""
        if mask.all() or not mask.any():
            return bool(mask.all())
        return torch.as_tensor(mask, device=device)[:, None]

    def sel(mask, a, b):
        """a on the lanes of ``mask`` (from lane_mask), else b."""
        if isinstance(mask, bool):
            return a if mask else b
        return torch.where(mask, a, b)

    levels = []
    jnt_row = np.zeros(max(topo.njnt, 1), np.int64)  # joint -> row of the stacked anchors
    n_rows = 0
    for li, lvl in enumerate(topo.levels):
        n = len(lvl)
        slots = []
        for s in range(topo.max_slots):
            jtype = topo.lv_jtype[li, :n, s]
            present = {int(t) for t in jtype} - {JNT_NONE}
            if not present:
                continue
            qadr = topo.lv_qadr[li, :n, s]
            real = jtype != JNT_NONE
            jnt_row[topo.lv_jid[li, :n, s][real]] = n_rows + np.nonzero(real)[0]
            n_rows += n
            slots.append(
                dict(
                    jid=idx(topo.lv_jid[li, :n, s]),
                    q1=idx(np.minimum(qadr, nq - 1)),
                    qv7=idx(np.minimum(qadr[:, None] + n7, nq - 1)),
                    present=present,
                    ball=lane_mask(jtype == JNT_BALL),
                    free=lane_mask(jtype == JNT_FREE),
                    slide=lane_mask(jtype == JNT_SLIDE),
                    turn=lane_mask((jtype == JNT_HINGE) | (jtype == JNT_BALL)),
                )
            )
        levels.append((idx(topo.lv_body[li, :n]), idx(topo.lv_parent[li, :n]), slots))
    jnt_row_t = idx(jnt_row[: topo.njnt])
    site_body = idx(topo.site_bodyid)

    def fk(params: KinParams, qpos: torch.Tensor) -> FKResult:
        F = qpos.shape[0]
        frames = torch.zeros((F, topo.nbody, 7), dtype=qpos.dtype, device=qpos.device)
        frames[..., 3] = 1.0  # xpos | xquat, the world body at the identity
        jnt_pos_axis = torch.stack([params.jnt_pos, params.jnt_axis], dim=-2)  # (njnt, 2, 3)
        anchor_axes = []  # per slot: (F, n, 2, 3) world anchor | world axis
        for body, parent, slots in levels:
            pframe = qm.take(frames, 1, parent)
            ppos, pquat = pframe[..., :3], pframe[..., 3:]
            pos = ppos + qm.quat_rotate(pquat, params.body_pos[body])
            quat = qm.quat_mul(pquat, params.body_quat[body])
            for sl in slots:
                present = sl["present"]
                pos_axis = jnt_pos_axis[sl["jid"]]  # (n, 2, 3)
                jpos, axis = pos_axis[:, 0], pos_axis[:, 1]
                if present & {JNT_BALL, JNT_FREE}:
                    qv7 = qm.take(qpos, 1, sl["qv7"])  # (F, n, 7)
                if present & {JNT_HINGE, JNT_SLIDE}:
                    dq = qm.take(qpos, 1, sl["q1"]) - params.qpos0[sl["q1"]]
                if present - {JNT_FREE}:
                    # Anchor and axis in the world, from the frame before the joint.
                    rotated = qm.quat_rotate(quat[..., None, :], pos_axis)
                    anchor_axis = torch.cat([pos[..., None, :] + rotated[..., :1, :], rotated[..., 1:, :]], dim=-2)
                else:
                    anchor_axis = torch.stack([pos, axis.expand(F, -1, -1)], dim=-2)
                new_pos, new_quat = pos, quat
                if present & {JNT_HINGE, JNT_BALL}:
                    # Hinge and ball lanes turn the frame about the anchor by
                    # their local rotation.
                    local = qm.axis_angle_quat(axis, dq) if JNT_HINGE in present else None
                    if JNT_BALL in present:
                        ball = qm.quat_normalize(qv7[..., :4])
                        local = ball if local is None else sel(sl["ball"], ball, local)
                    turned = qm.quat_mul(quat, local)
                    turned_pos = anchor_axis[..., 0, :] - qm.quat_rotate(turned, jpos)
                    new_pos = sel(sl["turn"], turned_pos, new_pos)
                    new_quat = sel(sl["turn"], turned, new_quat)
                if JNT_SLIDE in present:
                    new_pos = sel(sl["slide"], pos + anchor_axis[..., 1, :] * dq[..., None], new_pos)
                if JNT_FREE in present:
                    # Free lanes take the frame from qpos; their anchor is the
                    # qpos translation and their axis the raw local axis.
                    free_pos = qv7[..., :3]
                    new_pos = sel(sl["free"], free_pos, new_pos)
                    new_quat = sel(sl["free"], qm.quat_normalize(qv7[..., 3:7]), new_quat)
                    free_anchor_axis = torch.stack([free_pos, axis.expand(F, -1, -1)], dim=-2)
                    free = sl["free"] if isinstance(sl["free"], bool) else sl["free"][..., None]
                    anchor_axis = sel(free, free_anchor_axis, anchor_axis)
                anchor_axes.append(anchor_axis)
                pos, quat = new_pos, new_quat
            quat = qm.quat_normalize(quat)
            frames = frames.index_copy(1, body, torch.cat([pos, quat], dim=-1))

        xpos, xquat = frames[..., :3], frames[..., 3:]
        if anchor_axes:
            per_joint = qm.take(torch.cat(anchor_axes, dim=1), 1, jnt_row_t)  # (F, njnt, 2, 3)
            xanchor, xaxis = per_joint[..., 0, :], per_joint[..., 1, :]
        else:
            xanchor = xaxis = torch.zeros((F, 1, 3), dtype=qpos.dtype, device=qpos.device)
        site_xpos = qm.take(xpos, 1, site_body) + qm.quat_rotate(qm.take(xquat, 1, site_body), params.site_pos)
        return FKResult(xpos=xpos, xquat=xquat, site_xpos=site_xpos, xanchor=xanchor, xaxis=xaxis)

    return _spanned(fk)


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

        site_xpos = qm.take(xpos, 1, site_body) + qm.quat_rotate(qm.take(xquat, 1, site_body), params.site_pos)
        return FKResult(xpos=xpos, xquat=xquat, site_xpos=site_xpos, xanchor=xanchor, xaxis=xaxis)

    return _spanned(fk)


def make_site_fk(topo: KinTopology, site_idxs: np.ndarray, device: torch.device | str = "cuda"):
    """Level-scan FK of a subset of sites: ``site_fk(params, qpos (F, nq))
    -> site_xpos (F, len(site_idxs), 3)``, on the card unless ``device``
    says otherwise."""
    from stac_mjx_tpu_torch.bridge import resolve_device

    device = resolve_device(device)
    fk = make_fk(topo, device)
    idx = torch.as_tensor(np.ascontiguousarray(site_idxs, dtype=np.int64), device=device)

    def site_fk(params: KinParams, qpos: torch.Tensor) -> torch.Tensor:
        return fk(params, qpos).site_xpos[:, idx]

    return site_fk


def subtree_com(
    topo: KinTopology, body_mass: np.ndarray, body_ipos: np.ndarray, device: torch.device | str = "cuda"
):
    """Subtree centres of mass (the analogue of mjx ``com_pos``):
    ``com(xpos (T, nbody, 3), xquat (T, nbody, 4)) -> (T, nbody, 3)``.

    The JAX version's arithmetic: ``xipos = xpos + rotate(xquat, ipos)``,
    the mass-weighted xipos summed bottom-up over each subtree, divided by
    ``max(subtree mass, 1e-12)`` (the subtree masses summed on the host in
    float64). The JAX version adds each child into its parent with one
    update per body pair; here the sums go one depth level at a time,
    deepest first: level d's rows are added into their parents (level d-1)
    with one ``index_add_``, so a body's row holds its whole subtree before
    its own level is added up. That is O(depth) launches over
    ``topo.levels``, the tables the level-scan FK walks. On the CPU the
    children of one parent are added in the level's (ascending) body order,
    the JAX loop's order; on a card ``index_add_`` adds them atomically, in
    no fixed order. The float64 tables are rounded to the frames' dtype once,
    at that dtype's first call, so a call launches only the rotation, the
    level adds and the division."""
    from stac_mjx_tpu_torch.bridge import resolve_device

    device = resolve_device(device)
    mass = np.asarray(body_mass, dtype=np.float64)
    subtree_mass = mass.copy()
    for b in range(topo.nbody - 1, 0, -1):
        subtree_mass[topo.body_parentid[b]] += subtree_mass[b]

    def table(a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=device)

    # (ipos (nbody, 3), mass (nbody, 1), max(subtree mass, 1e-12) (nbody, 1)).
    tables64 = (table(np.asarray(body_ipos, dtype=np.float64)), table(mass[:, None]),
                table(np.maximum(subtree_mass, 1e-12)[:, None]))
    typed = {torch.float64: tables64}
    # Deepest level first: (bodies of the level, their parents).
    levels = [(table(lvl.astype(np.int64)), table(topo.body_parentid[lvl].astype(np.int64)))
              for lvl in reversed(topo.levels)]

    def com(xpos: torch.Tensor, xquat: torch.Tensor) -> torch.Tensor:
        if xpos.dtype not in typed:
            typed[xpos.dtype] = tuple(t.to(xpos.dtype) for t in tables64)
        ipos, body_m, denom = typed[xpos.dtype]
        acc = (xpos + qm.quat_rotate(xquat, ipos)) * body_m
        for body, parent in levels:
            acc.index_add_(1, parent, acc[:, body])
        return acc / denom

    return com
