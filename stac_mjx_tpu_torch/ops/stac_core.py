"""STAC solver core: q-phase solves and the closed-form m-phase
(port of ``stac_mjx_tpu/ops/stac_core.py``, Gauss-Newton path).
"""

from __future__ import annotations

import numpy as np
import torch

from stac_mjx_tpu_torch.models.kinematics import KinParams, KinTopology, make_fk_jump
from stac_mjx_tpu_torch.ops.gn_ik import GNIK
from stac_mjx_tpu_torch.ops.solver import MOptResult, PGResult, m_opt_closed_form

_PARITY_PATH = "the parity path is not ported yet (ROADMAP.md, modules still open)"


def make_qs(q0: torch.Tensor, qs_to_opt: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Optimized entries where ``qs_to_opt``, initial ones elsewhere."""
    return torch.where(qs_to_opt, q, q0)


class StacCore:
    """Pose (flat LM) and offset (closed-form) solves for one topology on one device."""

    def __init__(
        self,
        topo: KinTopology,
        site_idxs: np.ndarray,
        device: torch.device | str,
        n_iter_q: int = 400,
        q_solver: str = "gn-lm",
        fk_impl: str = "jump",
        gn_stall_iters: int = 0,
        gn_damping_rule: str = "nielsen",
        gn_iters: int = 0,
    ):
        """q_solver: only "gn-lm" (flat Levenberg-Marquardt) is ported.
        fk_impl: only "jump" (pointer doubling). gn_iters=0 picks 14 LM
        iterations under the nielsen rule and 16 under "fixed", capped by
        n_iter_q. (FTOL only feeds the JAX solver's stall rule and linesearch,
        neither of which is ported, so it is not an argument here.)"""
        if q_solver in ("pg", "pg-jaxopt", "gn"):
            raise NotImplementedError(f"q_solver={q_solver!r}: {_PARITY_PATH}")
        if q_solver != "gn-lm":
            raise ValueError(f"unknown q_solver {q_solver!r}")
        if fk_impl != "jump":
            raise NotImplementedError(f"fk_impl={fk_impl!r}: {_PARITY_PATH}")
        if gn_stall_iters:
            raise NotImplementedError(
                "gn_stall_iters > 0 (per-lane freezing with early exit) is not ported"
            )
        self.topo = topo
        self.device = torch.device(device)
        self.site_idxs = np.asarray(site_idxs)
        self.site_idxs_t = torch.as_tensor(self.site_idxs.astype(np.int64), device=self.device)
        site_body = topo.site_bodyid[self.site_idxs].astype(np.int64)
        self._site_body = torch.as_tensor(site_body, device=self.device)
        self.fk = make_fk_jump(topo, device)
        auto_iters = 14 if gn_damping_rule == "nielsen" else 16
        self.gnik = GNIK(
            topo,
            self.site_idxs,
            device,
            maxiter=gn_iters if gn_iters > 0 else min(n_iter_q, auto_iters),
            damping_rule=gn_damping_rule,
        )

    def q_opt(self, params, kp_data, qs_to_opt, kps_to_opt, q0, lb, ub) -> PGResult:
        """One box-constrained pose solve for a single frame (flat LM)."""
        return self.gnik.solve(params, kp_data, qs_to_opt, kps_to_opt, q0, lb, ub)

    def q_opt_batch(
        self, params, kp_data, qs_to_opt, kps_to_opt, q0, lb, ub, maxiter=None
    ) -> PGResult:
        """Pose solves over a frame batch (kp_data/q0 are (F, ·)); qs_to_opt
        is (nq,) shared or (F, nq) per item."""
        return self.gnik.solve_batch(
            params, kp_data, qs_to_opt, kps_to_opt, q0, lb, ub, maxiter=maxiter
        )

    def site_frames(self, params: KinParams, q: torch.Tensor):
        """Parent-body frames of every keypoint site: q (T, nq) ->
        p_all (T, K, 3), R_all (T, K, 3, 3)."""
        res = self.fk(params, q)
        return res.xpos[:, self._site_body], res.xmat()[:, self._site_body]

    def m_opt(
        self, params, keypoints, q, initial_offsets, is_regularized, reg_coef
    ) -> MOptResult:
        """Closed-form offsets from sampled frames: keypoints (T, 3K), q (T, nq)."""
        T = keypoints.shape[0]
        y = keypoints.reshape(T, len(self.site_idxs), 3)
        p_all, R_all = self.site_frames(params, q)
        return m_opt_closed_form(p_all, R_all, y, initial_offsets, is_regularized, reg_coef)
