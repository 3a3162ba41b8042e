"""STAC solver core: q-phase loss and solves, closed-form m-phase
(port of ``stac_mjx_tpu/ops/stac_core.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from stac_mjx_tpu_torch.models.kinematics import KinParams, KinTopology, make_fk, make_fk_jump
from stac_mjx_tpu_torch.ops import quat as qm
from stac_mjx_tpu_torch.ops.gn_ik import GNIK
from stac_mjx_tpu_torch.ops.solver import (
    MOptResult,
    PGResult,
    ProjectedGradient,
    m_opt_closed_form,
)

Q_SOLVERS = ("pg", "pg-jaxopt", "gn", "gn-lm")


def make_qs(q0: torch.Tensor, qs_to_opt: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Optimized entries where ``qs_to_opt``, initial ones elsewhere."""
    return torch.where(qs_to_opt, q, q0)


class StacCore:
    """Pose (projected gradient or Gauss-Newton) and offset (closed-form)
    solves for one topology on one device."""

    def __init__(
        self,
        topo: KinTopology,
        site_idxs: np.ndarray,
        device: torch.device | str,
        tol: float = 1e-5,
        n_iter_q: int = 400,
        q_solver: str = "pg",
        fk_impl: str = "scan",
        gn_stall_iters: int = 0,
        gn_damping_rule: str = "nielsen",
        gn_iters: int = 0,
    ):
        """q_solver: "pg" (projected gradient, robust float32 policy),
        "pg-jaxopt" (the jaxopt-0.8.5 iteration, the parity numerics), "gn"
        (Gauss-Newton with a linesearch on the damping) or "gn-lm" (flat
        Levenberg-Marquardt, the lockstep throughput solver). fk_impl:
        "scan" (level scan) or "jump" (pointer doubling). tol: the PG
        stopping tolerance (FTOL); the linesearch GN stops on tol**2.
        gn_iters=0 picks 14 iterations for gn-lm under the nielsen rule and
        16 otherwise, capped by n_iter_q. gn_stall_iters > 0 freezes a lane
        of the batched flat LM after that many iterations without a gain
        above tol**2, and ends the loop once every lane is frozen."""
        if q_solver not in Q_SOLVERS:
            raise ValueError(f"unknown q_solver {q_solver!r}")
        if fk_impl not in ("scan", "jump"):
            raise ValueError(f"unknown fk_impl {fk_impl!r}")
        self.topo = topo
        self.device = torch.device(device)
        self.q_solver = q_solver
        self.fk_impl = fk_impl
        self.site_idxs = np.asarray(site_idxs)
        self.site_idxs_t = torch.as_tensor(self.site_idxs.astype(np.int64), device=self.device)
        site_body = topo.site_bodyid[self.site_idxs].astype(np.int64)
        self._site_body = torch.as_tensor(site_body, device=self.device)
        self.fk = (make_fk_jump if fk_impl == "jump" else make_fk)(topo, device)
        self.solver = ProjectedGradient(
            maxiter=n_iter_q, tol=tol, jaxopt_mode=(q_solver == "pg-jaxopt")
        )
        self.gnik = None
        if q_solver.startswith("gn"):
            auto_iters = 14 if (q_solver == "gn-lm" and gn_damping_rule == "nielsen") else 16
            self.gnik = GNIK(
                topo,
                self.site_idxs,
                device,
                maxiter=gn_iters if gn_iters > 0 else min(n_iter_q, auto_iters),
                tol=tol * tol,
                fk_impl=fk_impl,
                linesearch=(q_solver == "gn"),
                damping_rule=gn_damping_rule,
                stall_iters=gn_stall_iters,
            )

    # ------------------------------------------------------------------ q

    def q_loss(self, q, params: KinParams, kp_data, qs_to_opt, kps_to_opt, initial_q) -> torch.Tensor:
        """Masked SSE between keypoints and FK'd marker sites, per lane:
        q, initial_q (B, nq), kp_data (B, 3K) -> (B,)."""
        qpos = make_qs(initial_q, qs_to_opt, q)
        site_xpos = self.fk(params, qpos).site_xpos
        markers = qm.take(site_xpos, 1, self.site_idxs_t).reshape(q.shape[0], -1)
        residual = (kp_data - markers) * kps_to_opt
        return torch.sum(residual * residual, dim=-1)

    def q_opt(self, params, kp_data, qs_to_opt, kps_to_opt, q0, lb, ub) -> PGResult:
        """Single-frame pose solves on independent lanes (kp_data (B, 3K),
        q0 (B, nq), qs_to_opt (nq,) or (B, nq)): each lane as the JAX
        ``q_opt`` under vmap (one frame is B = 1). Callers re-mask with
        ``make_qs``."""
        if self.gnik is not None:
            return self.gnik.solve(params, kp_data, qs_to_opt, kps_to_opt, q0, lb, ub)

        def fun(q):
            return self.q_loss(q, params, kp_data, qs_to_opt, kps_to_opt, q0)

        return self.solver.run(fun, q0, lb, ub)

    def q_opt_batch(
        self, params, kp_data, qs_to_opt, kps_to_opt, q0, lb, ub, maxiter=None
    ) -> PGResult:
        """Pose solves over a frame batch (kp_data/q0 are (F, ·)); qs_to_opt
        is (nq,) shared or (F, nq) per item. gn-lm runs the natively batched
        flat LM (``maxiter`` overrides its count); every other solver keeps
        its single-frame semantics over the lanes and ignores ``maxiter``."""
        if self.q_solver == "gn-lm":
            return self.gnik.solve_batch(
                params, kp_data, qs_to_opt, kps_to_opt, q0, lb, ub, maxiter=maxiter
            )
        return self.q_opt(params, kp_data, qs_to_opt, kps_to_opt, q0, lb, ub)

    # ------------------------------------------------------------------ m

    def site_frames(self, params: KinParams, q: torch.Tensor):
        """Parent-body frames of every keypoint site: q (T, nq) ->
        p_all (T, K, 3), R_all (T, K, 3, 3)."""
        res = self.fk(params, q)
        return res.xpos[:, self._site_body], res.xmat()[:, self._site_body]

    def m_opt(
        self,
        params,
        keypoints,
        q,
        initial_offsets,
        is_regularized,
        reg_coef,
        n_frames_total=None,
        group=None,
    ) -> MOptResult:
        """Closed-form offsets from sampled frames: keypoints (T, 3K), q (T, nq).
        With a process ``group`` the frame statistics are all-reduced over its
        ranks (the frame-sharded fit; ``m_opt_closed_form``)."""
        T = keypoints.shape[0]
        y = keypoints.reshape(T, len(self.site_idxs), 3)
        p_all, R_all = self.site_frames(params, q)
        return m_opt_closed_form(
            p_all, R_all, y, initial_offsets, is_regularized, reg_coef,
            n_frames_total=n_frames_total, group=group,
        )
