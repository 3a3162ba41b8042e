"""Gauss-Newton / Levenberg-Marquardt IK with analytic Jacobians
(port of ``stac_mjx_tpu/ops/gn_ik.py``, flat-LM schedule).

Steps live in MuJoCo dof space (R^nv). Retraction: slide/hinge and free
translation add the step; free/ball quaternions take a local increment,
``quat <- normalize(quat) * exp(delta)``. The world axis of local rotation
dof i is ``R_body e_i`` about the joint anchor, so every Jacobian column is
``axis x (p - anchor)`` (rotation) or ``axis`` (translation), read off one
FK pass. Masked dofs get zero columns and a zero step; box bounds clip every
non-quaternion coordinate after the retraction.

Both flat-LM entries are here: ``solve_batch`` (the lockstep path, damping
passed to the SPD kernel per frame) and ``solve`` (one frame; the fit's root
solve; damping added into A before the solve). The linesearch GN of the JAX
``GNIK.solve`` is part of the parity path and not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from stac_mjx_tpu_torch.models.kinematics import (
    JNT_BALL,
    JNT_FREE,
    JNT_HINGE,
    JNT_SLIDE,
    FKResult,
    KinParams,
    KinTopology,
    make_fk_jump,
)
from stac_mjx_tpu_torch.ops import quat as qm
from stac_mjx_tpu_torch.ops.solver import PGResult
from stac_mjx_tpu_torch.ops.spd import spd_solve


class GNIK:
    """Per-topology flat Levenberg-Marquardt IK solver on one device."""

    def __init__(
        self,
        topo: KinTopology,
        site_idxs: np.ndarray,
        device: torch.device | str,
        maxiter: int = 12,
        damping_init: float = 1e-4,
        damping_inc: float = 10.0,
        damping_dec: float = 0.2,
        damping_rule: str = "nielsen",
    ):
        """damping_rule: "nielsen" (gain-ratio rule, Madsen-Nielsen-Tingleff
        alg. 3.16, with lambda clipped to [1e-7, 1e8] and rejects scaled by
        damping_inc) or "fixed" (x damping_inc on reject, x damping_dec on
        accept). It drives ``solve_batch``; ``solve`` always uses "fixed"."""
        if damping_rule not in ("nielsen", "fixed"):
            raise ValueError(f"unknown damping_rule {damping_rule!r}")
        self.device = torch.device(device)
        self.site_idxs = np.asarray(site_idxs)
        self.maxiter = maxiter
        self.damping_init = damping_init
        self.damping_inc = damping_inc
        self.damping_dec = damping_dec
        self.damping_rule = damping_rule
        self.fk = make_fk_jump(topo, device)

        nq, njnt = topo.nq, topo.njnt
        jnt_dofadr = np.concatenate([[0], np.cumsum(topo.jnt_dofnum)])[:-1]
        nv = int(topo.jnt_dofnum.sum())
        self.nv = nv

        # --- per-dof tables
        dof_jnt = np.zeros(nv, np.int64)  # owning joint
        dof_body = np.zeros(nv, np.int64)  # owning body
        dof_rot = np.zeros(nv, bool)  # rotational dof
        dof_local_rot = np.zeros(nv, bool)  # local-frame rotation (free/ball)
        dof_axis_i = np.zeros(nv, np.int64)  # e_i index for local rot / free trans
        dof_trans_world = np.zeros(nv, bool)  # free translation
        v_from_q = np.zeros((nv, nq), np.float32)  # qpos mask -> dof mask
        lin_q, lin_d = [], []  # retraction: q[lin_q] += delta[lin_d]
        quat_q, quat_d = [], []  # retraction: quat spans and their rotation dofs
        for j in range(njnt):
            t = int(topo.jnt_type[j])
            qa = int(topo.jnt_qposadr[j])
            da = int(jnt_dofadr[j])
            b = int(topo.jnt_bodyid[j])
            if t in (JNT_HINGE, JNT_SLIDE):
                dof_jnt[da] = j
                dof_body[da] = b
                dof_rot[da] = t == JNT_HINGE
                v_from_q[da, qa] = 1.0
                lin_q.append(qa)
                lin_d.append(da)
            elif t == JNT_FREE:
                for i in range(3):
                    dof_jnt[da + i] = j
                    dof_body[da + i] = b
                    dof_trans_world[da + i] = True
                    dof_axis_i[da + i] = i
                    v_from_q[da + i, qa + i] = 1.0
                    lin_q.append(qa + i)
                    lin_d.append(da + i)
                for i in range(3):
                    d = da + 3 + i
                    dof_jnt[d] = j
                    dof_body[d] = b
                    dof_rot[d] = True
                    dof_local_rot[d] = True
                    dof_axis_i[d] = i
                    v_from_q[d, qa + 3 : qa + 7] = 1.0
                quat_q.append(range(qa + 3, qa + 7))
                quat_d.append(range(da + 3, da + 6))
            elif t == JNT_BALL:
                for i in range(3):
                    d = da + i
                    dof_jnt[d] = j
                    dof_body[d] = b
                    dof_rot[d] = True
                    dof_local_rot[d] = True
                    dof_axis_i[d] = i
                    v_from_q[d, qa : qa + 4] = 1.0
                quat_q.append(range(qa, qa + 4))
                quat_d.append(range(da, da + 3))

        # --- subtree (ancestor) masks: is site k moved by dof d?
        K = len(self.site_idxs)
        site_body = topo.site_bodyid[self.site_idxs]
        anc = np.zeros((K, nv), np.float32)
        for k in range(K):
            chain = set()
            b = int(site_body[k])
            while b != 0:
                chain.add(b)
                b = int(topo.body_parentid[b])
            for d in range(nv):
                if int(dof_body[d]) in chain:
                    anc[k, d] = 1.0

        # --- bounds clip mask: every qpos coordinate except quaternions.
        clipmask = np.ones(nq, bool)
        for span in quat_q:
            clipmask[list(span)] = False

        def dev(a, dtype=None):
            return torch.as_tensor(np.asarray(a, dtype=dtype), device=self.device)

        self._site_idxs = dev(self.site_idxs, np.int64)
        self._dof_jnt = dev(dof_jnt)
        self._dof_body = dev(dof_body)
        self._dof_axis_i = dev(dof_axis_i)
        self._dof_rot = dev(dof_rot)[None, None, :, None]
        self._dof_local_rot = dev(dof_local_rot)[:, None]
        self._dof_trans_world = dev(dof_trans_world)[:, None]
        self._ar_nv = torch.arange(nv, device=self.device)
        self._v_from_q = dev(v_from_q)
        self._site_dof_mask = dev(anc)[None, :, :, None]
        self._clip_mask = dev(clipmask)
        self._lin_q, self._lin_d = dev(lin_q, np.int64), dev(lin_d, np.int64)
        self._quat_q = dev(np.array([list(r) for r in quat_q], np.int64).reshape(-1, 4))
        self._quat_d = dev(np.array([list(r) for r in quat_d], np.int64).reshape(-1, 3))
        self._eye3 = torch.eye(3, device=self.device)

    # ----------------------------------------------------------- retraction

    def retract(self, q: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
        """Apply dof-space steps delta (F, nv) to qpos q (F, nq)."""
        q_new = q.clone()
        q_new[:, self._lin_q] = q[:, self._lin_q] + delta[:, self._lin_d]
        quat = qm.quat_normalize(q[:, self._quat_q])
        q_new[:, self._quat_q] = qm.quat_mul(quat, qm.quat_exp(delta[:, self._quat_d]))
        return q_new

    # ------------------------------------------------------------- jacobian

    def jacobian_cols(self, fkres: FKResult) -> torch.Tensor:
        """(F, K, nv, 3) Jacobian columns: cols[f, k, d, c] = d p_kc / d delta_d."""
        p = fkres.site_xpos[:, self._site_idxs]  # (F, K, 3)
        dtype = p.dtype
        xmt = fkres.xmat()[:, self._dof_body].transpose(-1, -2)  # (F, nv, 3, 3)
        ax_local = xmt[:, self._ar_nv, self._dof_axis_i]  # R e_i, (F, nv, 3)
        ax_scalar = fkres.xaxis[:, self._dof_jnt]  # hinge/slide
        ax_trans = self._eye3.to(dtype)[self._dof_axis_i]
        axes = torch.where(
            self._dof_trans_world,
            ax_trans,
            torch.where(self._dof_local_rot, ax_local, ax_scalar),
        )
        # Free-joint rotation anchors are the body origin = the free joint's xanchor.
        anchors = fkres.xanchor[:, self._dof_jnt]
        rel = p[:, :, None, :] - anchors[:, None, :, :]  # (F, K, nv, 3)
        axes_k = axes[:, None].expand_as(rel)
        rot_cols = torch.linalg.cross(axes_k, rel, dim=-1)
        cols = torch.where(self._dof_rot, rot_cols, axes_k)
        return cols * self._site_dof_mask.to(dtype)

    def jacobian(self, fkres: FKResult) -> torch.Tensor:
        """(F, 3K, nv) site-position Jacobian: J[f, (k, c), d]."""
        cols = self.jacobian_cols(fkres)
        F = cols.shape[0]
        return cols.transpose(-1, -2).reshape(F, -1, self.nv)

    # ------------------------------------------------------------- solves

    def _dof_mask(self, qs_to_opt: torch.Tensor, dtype) -> torch.Tensor:
        """qpos mask (nq,) or (F, nq) -> dof mask (1, nv) or (F, nv), 0/1."""
        qs = qs_to_opt.to(dtype).reshape(-1, qs_to_opt.shape[-1])
        return (qs @ self._v_from_q.to(dtype).T > 0).to(dtype)

    def _flat_lm(self, params, kp_data, kmask, dof_mask, q0, lb, ub, maxiter, nielsen, lam_in_a):
        """The flat LM loop over a batch of F frames: one FK, Jacobian and SPD
        solve per iteration, accept iff the loss drops, per-frame damping."""
        F = q0.shape[0]
        dtype = q0.dtype
        lb_c = torch.clamp(lb, -1e10, 1e10)
        ub_c = torch.clamp(ub, -1e10, 1e10)

        def project(q):
            return torch.where(self._clip_mask, torch.clamp(q, lb_c, ub_c), q)

        def err_of(fkres):
            p = fkres.site_xpos[:, self._site_idxs].reshape(F, -1)
            return (p - kp_data) * kmask

        eye = torch.eye(self.nv, dtype=dtype, device=q0.device)
        jmask = kmask[None, :, None] * dof_mask[:, None, :]
        q = project(q0)
        fkres = self.fk(params, q)
        e = err_of(fkres)
        f_x = torch.sum(e * e, dim=-1)
        lam = torch.full((F,), self.damping_init, dtype=dtype, device=q0.device)
        for _ in range(maxiter):
            e = err_of(fkres)
            J = self.jacobian(fkres) * jmask
            Jt = J.transpose(1, 2)
            A = torch.bmm(Jt, J)
            g = torch.bmm(Jt, e[..., None])[..., 0]
            if lam_in_a:
                x = spd_solve(A + lam[:, None, None] * eye, g)
            else:
                x = spd_solve(A, g, lam)
            delta = -x * dof_mask
            q_new = project(self.retract(q, delta))
            fk_new = self.fk(params, q_new)
            e_new = err_of(fk_new)
            f_new = torch.sum(e_new * e_new, dim=-1)
            ok = f_new < f_x
            gain = torch.where(ok, f_x - f_new, torch.zeros_like(f_x))
            q = torch.where(ok[:, None], q_new, q)
            f_x = torch.where(ok, f_new, f_x)
            fkres = fk_new.where(ok, fkres)
            if nielsen:
                # rho = actual / predicted reduction of the unprojected step,
                # pred = delta.(lam delta - g); f_x is e'e = 2F, and the
                # missing 1/2 cancels between gain and pred.
                pred = torch.sum(delta * (lam[:, None] * delta - g), dim=-1)
                rho = gain / torch.clamp(pred, min=1e-30)
                shrink = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
                lam_acc = torch.clamp(lam * shrink, 1e-7, 1e8)
                lam_rej = torch.clamp(lam * self.damping_inc, 1e-7, 1e8)
            else:
                lam_acc = lam * self.damping_dec
                lam_rej = lam * self.damping_inc
            lam = torch.where(ok, lam_acc, lam_rej)
        return PGResult(
            params=q,
            error=torch.sqrt(f_x),
            value=f_x,
            iters=torch.full((F,), maxiter, dtype=torch.int32, device=q0.device),
            stepsize=1.0 / (1.0 + lam),
        )

    def solve_batch(
        self,
        params: KinParams,
        kp_data: torch.Tensor,
        qs_to_opt: torch.Tensor,
        kps_to_opt: torch.Tensor,
        q0: torch.Tensor,
        lb: torch.Tensor,
        ub: torch.Tensor,
        maxiter: int | None = None,
    ) -> PGResult:
        """Flat LM over a frame batch: q0 (F, nq), kp_data (F, 3K).

        ``qs_to_opt`` is (nq,), shared by every frame, or (F, nq) per item.
        ``maxiter`` overrides the instance's iteration count for this solve.
        A fixed-count Python loop with no host sync (the JAX version's
        while_loop with stall freezing off).
        """
        dtype = q0.dtype
        return self._flat_lm(
            params,
            kp_data,
            kps_to_opt.to(dtype),
            self._dof_mask(qs_to_opt, dtype),
            q0,
            lb,
            ub,
            self.maxiter if maxiter is None else int(maxiter),
            nielsen=self.damping_rule == "nielsen",
            lam_in_a=False,
        )

    def solve(
        self,
        params: KinParams,
        kp_data: torch.Tensor,
        qs_to_opt: torch.Tensor,
        kps_to_opt: torch.Tensor,
        q0: torch.Tensor,
        lb: torch.Tensor,
        ub: torch.Tensor,
    ) -> PGResult:
        """Flat LM on one frame (q0 (nq,), kp_data (3K,)): the fixed x10/x0.2
        damping rule with lambda added into A before the solve."""
        dtype = q0.dtype
        res = self._flat_lm(
            params,
            kp_data[None],
            kps_to_opt.to(dtype),
            self._dof_mask(qs_to_opt, dtype),
            q0[None],
            lb,
            ub,
            self.maxiter,
            nielsen=False,
            lam_in_a=True,
        )
        return PGResult(*(a[0] for a in res))
