"""Gauss-Newton / Levenberg-Marquardt IK with analytic Jacobians
(port of ``stac_mjx_tpu/ops/gn_ik.py``, flat-LM schedule).

Steps live in MuJoCo dof space (R^nv). Retraction: slide/hinge and free
translation add the step; free/ball quaternions take a local increment,
``quat <- normalize(quat) * exp(delta)``. The world axis of local rotation
dof i is ``R_body e_i`` about the joint anchor, so every Jacobian column is
``axis x (p - anchor)`` (rotation) or ``axis`` (translation), read off one
FK pass. Masked dofs get zero columns and a zero step; box bounds clip every
non-quaternion coordinate after the retraction.

Three schedules are here: ``solve_batch`` (the flat LM over a frame batch,
damping passed to the SPD kernel per frame: the lockstep path), and
``solve``, the single-frame solve run over independent lanes, which is
either the flat LM (fixed damping rule, damping added into A before the
solve) or, with ``linesearch``, damped Gauss-Newton with a backtracking
linesearch on the damping.

On the card a fixed-count flat LM solve of up to ``_GRAPH_MAX_FRAMES``
frames replays from a CUDA graph (``GNIK._flat_lm``, ``_LMGraph``): its host
would otherwise dispatch some 375 kernels an iteration, which takes longer
than the card's work on them.
"""

from __future__ import annotations

import collections
import dataclasses

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
    make_fk,
    make_fk_jump,
)
from stac_mjx_tpu_torch.ops import quat as qm
from stac_mjx_tpu_torch.ops import spd
from stac_mjx_tpu_torch.ops.solver import PGResult
from stac_mjx_tpu_torch.ops.spd import spd_solve
from stac_mjx_tpu_torch.utils.lanes import while_lanes
from stac_mjx_tpu_torch.utils.profiling import annotate

# The largest frame batch whose flat LM solve replays from a CUDA graph.
# On an H100 the host dispatches an eager iteration in ~7.5 ms at any F up to
# 23,040, while a replayed one takes the card's time, 0.5 ms at F = 1 to
# 3.6 ms at F = 16,384 (2.1x faster); the graph's memory pool grows with F,
# 1.3 GB at 16,384 (scripts/time_lm_graphs.py; PERF.md keeps the sweep).
_GRAPH_MAX_FRAMES = 16384
# Captured solves a GNIK keeps, the least recently used dropped first.
_GRAPH_CACHE_SIZE = 8


def _graph_device(t: torch.Tensor) -> bool:
    """Whether a solve on ``t`` can be captured: a CUDA tensor, and no
    capture under way (a solve inside one is part of it)."""
    return t.is_cuda and not torch.cuda.is_current_stream_capturing()


def _tensors(args) -> list[torch.Tensor]:
    """The tensors of ``_flat_lm``'s inputs (params, kp_data, kmask,
    dof_mask, q0, lb, ub): the seven of ``KinParams``, then the rest."""
    params, *rest = args
    return [getattr(params, f.name) for f in dataclasses.fields(params)] + rest


def _args(params, tensors):
    """``_tensors``' inverse, with ``params``' type."""
    names = [f.name for f in dataclasses.fields(params)]
    return (dataclasses.replace(params, **dict(zip(names, tensors))), *tensors[len(names):])


class _LMGraph:
    """One fixed-count flat LM solve captured into a CUDA graph, over static
    copies of its inputs. A call copies the inputs in, replays the graph and
    returns clones of its outputs: the kernels of the eager loop, in its
    order, on the same shapes, so the results are bitwise the eager ones.

    ``solve(*args) -> PGResult`` must make no host sync. Spans it opens
    record at the capture only: a replay runs no Python.
    """

    def __init__(self, solve, args):
        self.device = args[4].device  # q0's
        self.static = [t.detach().clone(memory_format=torch.contiguous_format) for t in _tensors(args)]
        static_args = _args(args[0], self.static)
        before, before_width = spd.KERNEL_LAUNCHES, spd.LAUNCHES_BY_WIDTH.copy()
        with annotate("lm.capture"):
            self.out = self._capture(lambda: solve(*static_args))
        # A capture launches nothing; each replay launches what it captured.
        self.launches = spd.KERNEL_LAUNCHES - before
        self.launches_by_width = spd.LAUNCHES_BY_WIDTH - before_width
        spd.KERNEL_LAUNCHES = before
        spd.LAUNCHES_BY_WIDTH.subtract(self.launches_by_width)

    def _capture(self, run) -> PGResult:
        # thread_local: the process group's watchdog thread may query its
        # events on the card while this thread captures.
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device), torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            return run()

    def _replay(self) -> None:
        with torch.cuda.device(self.device):
            self.graph.replay()

    def __call__(self, args) -> PGResult:
        with annotate("lm.replay"):
            for s, t in zip(self.static, _tensors(args)):
                s.copy_(t)
            self._replay()
            spd.KERNEL_LAUNCHES += self.launches
            spd.LAUNCHES_BY_WIDTH.update(self.launches_by_width)
            return PGResult(*(o.clone() for o in self.out))


class GNIK:
    """Per-topology Gauss-Newton / Levenberg-Marquardt IK solver on one device."""

    def __init__(
        self,
        topo: KinTopology,
        site_idxs: np.ndarray,
        device: torch.device | str,
        maxiter: int = 12,
        tol: float = 1e-8,
        damping_init: float = 1e-4,
        damping_inc: float = 10.0,
        damping_dec: float = 0.2,
        max_bad_steps: int = 4,
        fk_impl: str = "jump",
        linesearch: bool = False,
        damping_rule: str = "nielsen",
        stall_iters: int = 0,
    ):
        """damping_rule: "nielsen" (gain-ratio rule, Madsen-Nielsen-Tingleff
        alg. 3.16, with lambda clipped to [1e-7, 1e8] and rejects scaled by
        damping_inc) or "fixed" (x damping_inc on reject, x damping_dec on
        accept). It drives ``solve_batch``; ``solve``'s flat LM always uses
        "fixed". linesearch=True makes ``solve`` the linesearch GN: up to
        max_bad_steps damping increases per iteration, stopping once the
        accepted step's squared norm is <= tol. stall_iters > 0 (``solve_batch``
        only) freezes a frame once its loss has not dropped by more than tol
        for that many iterations in a row: its q, loss and lambda stop
        changing, and the loop ends when every frame is frozen."""
        if damping_rule not in ("nielsen", "fixed"):
            raise ValueError(f"unknown damping_rule {damping_rule!r}")
        self.device = torch.device(device)
        self.site_idxs = np.asarray(site_idxs)
        self.maxiter = maxiter
        self.tol = tol
        self.damping_init = damping_init
        self.damping_inc = damping_inc
        self.damping_dec = damping_dec
        self.max_bad_steps = max_bad_steps
        self.linesearch = linesearch
        self.damping_rule = damping_rule
        self.stall_iters = stall_iters
        self.fk = (make_fk_jump if fk_impl == "jump" else make_fk)(topo, device)

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
        # Flat LM solves by shape: None once seen, then the captured _LMGraph.
        self._graphs: collections.OrderedDict = collections.OrderedDict()

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

    @staticmethod
    def _gradient(J: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
        """J'e (F, nv) of J (F, 3K, nv) and e (F, 3K), as a sum per frame.

        cuBLAS's batched matrix-vector product (``torch.bmm`` with one
        column) picks its kernel by the batch count, so a frame's J'e, and
        with it the LM's accept tests and end point, would depend on how
        many frames share its solve. This sum rounds alike in any batch
        (checked on the H100 for 1 to 10,000 frames, as ``torch.bmm`` for
        J'J does), so clips solved in chunks or on other ranks end where
        one batch ends."""
        return torch.sum(J * e[..., None], dim=1)

    @staticmethod
    def _row_sum(x: torch.Tensor) -> torch.Tensor:
        """Sum over the last dim of x (F, n), in an order that no batch size changes.

        ``torch.sum(x, dim=-1)`` on a card picks its block shape by the row
        count, so its order, and with it the LM's loss, predicted gain and
        step norm, would depend on how many frames share the solve. Here each
        row is broadcast to 32 columns (a stride-0 view) and reduced over the
        middle dim, as ``_gradient`` reduces: one launch, and every row summed
        in the same order in any batch (measured on the H100 for 1 to 10,000
        rows, ``scripts/check_batch_invariance.py``; on the CPU it rounds as
        ``torch.sum``)."""
        return x[..., None].expand(*x.shape, 32).sum(-2)[..., 0]

    def _dof_mask(self, qs_to_opt: torch.Tensor, dtype) -> torch.Tensor:
        """qpos mask (nq,) or (F, nq) -> dof mask (1, nv) or (F, nv), 0/1."""
        qs = qs_to_opt.to(dtype).reshape(-1, qs_to_opt.shape[-1])
        return (qs @ self._v_from_q.to(dtype).T > 0).to(dtype)

    def _flat_lm(self, params, kp_data, kmask, dof_mask, q0, lb, ub, maxiter, nielsen, lam_in_a, stall_n=0):
        """The flat LM solve of a batch of F frames (``_lm_loop``), replayed
        from a CUDA graph where one holds it.

        A solve is graphed when its tensors are on a card, it runs a fixed
        count of iterations (stall_n 0: no host sync), autograd records
        nothing and F <= ``_GRAPH_MAX_FRAMES``. The first solve of a shape
        runs eager and is the warm-up, the second is captured and replayed,
        later ones replay. Graphs are kept by shape, at most
        ``_GRAPH_CACHE_SIZE``, the least recently used dropped first."""
        args = (params, kp_data, kmask, dof_mask, q0, lb, ub)
        with annotate("lm.solve"):
            key = self._graph_key(args, maxiter, nielsen, lam_in_a, stall_n)
            if key is None:
                return self._lm_loop(*args, maxiter, nielsen, lam_in_a, stall_n)
            if key not in self._graphs:
                self._graphs[key] = None
                if len(self._graphs) > _GRAPH_CACHE_SIZE:
                    self._graphs.popitem(last=False)
                return self._lm_loop(*args, maxiter, nielsen, lam_in_a)
            self._graphs.move_to_end(key)
            graph = self._graphs[key]
            if graph is None:
                graph = self._graphs[key] = _LMGraph(
                    lambda *a: self._lm_loop(*a, maxiter, nielsen, lam_in_a), args
                )
            return graph(args)

    @staticmethod
    def _graph_key(args, maxiter, nielsen, lam_in_a, stall_n):
        """The cache key of a graphable ``_flat_lm`` solve, or None where it
        runs eager: on the CPU, with stall freezing, under autograd, or past
        ``_GRAPH_MAX_FRAMES`` frames."""
        tensors = _tensors(args)
        q0 = args[4]
        if (
            stall_n
            or q0.shape[0] > _GRAPH_MAX_FRAMES
            or not _graph_device(q0)
            or (torch.is_grad_enabled() and any(t.requires_grad for t in tensors))
        ):
            return None
        return (str(q0.device), q0.dtype, maxiter, nielsen, lam_in_a,
                tuple((tuple(t.shape), t.dtype) for t in tensors))

    def _lm_loop(self, params, kp_data, kmask, dof_mask, q0, lb, ub, maxiter, nielsen, lam_in_a, stall_n=0):
        """The flat LM loop over a batch of F frames: one FK, Jacobian and SPD
        solve per iteration, accept iff the loss drops, per-frame damping.

        stall_n > 0 freezes a frame after stall_n iterations in a row whose
        gain is <= tol, and ends the loop once no frame is active; that test
        reads the active mask on the host once per iteration. With 0 the
        loop runs maxiter iterations and never syncs."""
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
        f_x = self._row_sum(e * e)
        lam = torch.full((F,), self.damping_init, dtype=dtype, device=q0.device)
        stall = torch.zeros(F, dtype=torch.int32, device=q0.device) if stall_n else None
        k = 0
        while k < maxiter:
            if stall is not None:
                active = stall < stall_n
                if not bool(active.any()):
                    break
            with annotate("lm.iter"):
                with annotate("lm.jacobian"):
                    e = err_of(fkres)
                    J = self.jacobian(fkres) * jmask
                    Jt = J.transpose(1, 2)
                    A = torch.bmm(Jt, J)
                    g = self._gradient(J, e)
                if lam_in_a:
                    x = spd_solve(A + lam[:, None, None] * eye, g)
                else:
                    x = spd_solve(A, g, lam)
                delta = -x * dof_mask
                q_new = project(self.retract(q, delta))
                fk_new = self.fk(params, q_new)
                e_new = err_of(fk_new)
                f_new = self._row_sum(e_new * e_new)
                ok = f_new < f_x
                if stall is not None:
                    ok = ok & active
                gain = torch.where(ok, f_x - f_new, torch.zeros_like(f_x))
                q = torch.where(ok[:, None], q_new, q)
                f_x = torch.where(ok, f_new, f_x)
                fkres = fk_new.where(ok, fkres)
                if nielsen:
                    # rho = actual / predicted reduction of the unprojected step,
                    # pred = delta.(lam delta - g); f_x is e'e = 2F, and the
                    # missing 1/2 cancels between gain and pred.
                    pred = self._row_sum(delta * (lam[:, None] * delta - g))
                    rho = gain / torch.clamp(pred, min=1e-30)
                    shrink = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
                    lam_acc = torch.clamp(lam * shrink, 1e-7, 1e8)
                    lam_rej = torch.clamp(lam * self.damping_inc, 1e-7, 1e8)
                else:
                    lam_acc = lam * self.damping_dec
                    lam_rej = lam * self.damping_inc
                lam_next = torch.where(ok, lam_acc, lam_rej)
                if stall is None:
                    lam = lam_next
                else:
                    lam = torch.where(active, lam_next, lam)
                    stall = torch.where(gain > self.tol, 0, stall + 1)
                k += 1
        return PGResult(
            params=q,
            error=torch.sqrt(f_x),
            value=f_x,
            iters=torch.full((F,), k, dtype=torch.int32, device=q0.device),
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
        With ``stall_iters`` 0 a fixed-count Python loop with no host sync,
        replayed from a CUDA graph on the card up to ``_GRAPH_MAX_FRAMES``
        frames; else the JAX version's stall freezing and early exit
        (``_flat_lm``).
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
            stall_n=self.stall_iters,
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
        """The single-frame solve, on one frame (q0 (nq,), kp_data (3K,)) or
        on independent lanes (q0 (B, nq), kp_data (B, 3K), qs_to_opt (nq,)
        or (B, nq)), each lane as the JAX ``GNIK.solve`` under vmap.

        Flat LM: the fixed x10/x0.2 damping rule with lambda added into A
        before the solve, a fixed iteration count. With ``linesearch``: the
        linesearch GN."""
        if q0.ndim == 1:
            res = self.solve(params, kp_data[None], qs_to_opt, kps_to_opt, q0[None], lb, ub)
            return PGResult(*(a[0] for a in res))
        dtype = q0.dtype
        args = (params, kp_data, kps_to_opt.to(dtype), self._dof_mask(qs_to_opt, dtype), q0, lb, ub)
        if self.linesearch:
            return self._linesearch_gn(*args)
        return self._flat_lm(*args, self.maxiter, nielsen=False, lam_in_a=True)

    def _linesearch_gn(self, params, kp_data, kmask, dof_mask, q0, lb, ub) -> PGResult:
        """Damped GN with a backtracking linesearch on lambda, per lane.

        Each iteration builds J'J and J'e once, then tries lambda, x10, x100
        ... (up to max_bad_steps) until the loss drops; an accepted step
        divides lambda by 1/damping_dec. A lane stops after maxiter
        iterations or once its accepted step's squared norm is <= tol.
        The JAX version factors JᵀJ + λI with ``jax.scipy.linalg.cho_factor``
        / ``cho_solve`` (XLA); here each trial is one ``spd_solve(JᵀJ, g,
        λ)`` over the lanes: the CUDA kernel on the card, and on the CPU its
        plain version, ``cholesky_ex`` + ``cholesky_solve`` of the same
        JᵀJ + λI. So a solve launches the kernel once per outer iteration
        plus once per linesearch retry.
        """
        B = q0.shape[0]
        dtype = q0.dtype
        lb_c = torch.clamp(lb, -1e10, 1e10)
        ub_c = torch.clamp(ub, -1e10, 1e10)
        jmask = kmask[None, :, None] * dof_mask[:, None, :]

        def project(q):
            return torch.where(self._clip_mask, torch.clamp(q, lb_c, ub_c), q)

        def err_of(fkres):
            return (fkres.site_xpos[:, self._site_idxs].reshape(B, -1) - kp_data) * kmask

        def loss_of(q):
            e = err_of(self.fk(params, q))
            return self._row_sum(e * e)

        def body(s, active):
            k, q, lam, step2, f_x = s
            fkres = self.fk(params, q)
            e = err_of(fkres)
            J = self.jacobian(fkres) * jmask
            Jt = J.transpose(1, 2)
            JtJ = torch.bmm(Jt, J)
            g = self._gradient(J, e)

            def try_step(c, _active=None):
                ls, lam_c, _, _, _ = c
                delta = -spd_solve(JtJ, g, lam_c) * dof_mask
                q_new = project(self.retract(q, delta))
                f_new = loss_of(q_new)
                ok = f_new < f_x
                return ls + 1, torch.where(ok, lam_c, lam_c * self.damping_inc), q_new, f_new, ok

            def ls_cond(c):
                ls, _, _, _, ok = c
                return ~ok & (ls < self.max_bad_steps) & active

            zero = torch.zeros(B, dtype=torch.int32, device=q0.device)
            carry = try_step((zero, lam, q, f_x, torch.zeros(B, dtype=torch.bool, device=q0.device)))
            _, lam_used, q_new, f_new, _ = while_lanes(ls_cond, try_step, carry)
            accepted = f_new < f_x
            q_next = torch.where(accepted[:, None], q_new, q)
            f_next = torch.where(accepted, f_new, f_x)
            lam_next = torch.where(accepted, lam_used * self.damping_dec, lam_used)
            d = q_next - q
            step2 = torch.where(accepted, self._row_sum(d * d), torch.zeros_like(f_x))
            return k + 1, q_next, lam_next, step2, f_next

        def cond(s):
            k, _, _, step2, _ = s
            return (k < self.maxiter) & ((k == 0) | (step2 > self.tol))

        q_start = project(q0)
        init = (
            torch.zeros(B, dtype=torch.int32, device=q0.device),
            q_start,
            torch.full((B,), self.damping_init, dtype=dtype, device=q0.device),
            torch.full((B,), float("inf"), dtype=dtype, device=q0.device),
            loss_of(q_start),
        )
        k, q, lam, step2, f_x = while_lanes(cond, body, init)
        return PGResult(
            params=q, error=torch.sqrt(step2), value=f_x, iters=k, stepsize=1.0 / (1.0 + lam)
        )
