"""Solver result types and the closed-form m-phase (port of ``stac_mjx_tpu/ops/solver.py``).

The projected-gradient solvers of the parity path are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PGResult(NamedTuple):
    """Result of a box-constrained pose solve.

    ``value`` is the masked SSE loss at the final iterate; ``error`` is the
    solver's own diagnostic (for the flat LM: sqrt of that loss);
    ``stepsize`` is 1 / (1 + lambda) for the LM solvers.
    """

    params: torch.Tensor  # final iterate (full q vector, box-projected)
    error: torch.Tensor
    value: torch.Tensor
    iters: torch.Tensor
    stepsize: torch.Tensor


class MOptResult(NamedTuple):
    """Result of the closed-form marker-offset solve."""

    params: torch.Tensor  # (K, 3) optimal offsets
    error: torch.Tensor  # scalar objective at the solution


def m_opt_closed_form(
    p_all: torch.Tensor,
    R_all: torch.Tensor,
    y: torch.Tensor,
    initial_offsets: torch.Tensor,
    is_regularized: torch.Tensor,
    reg_coef: float,
) -> MOptResult:
    """Exact minimizer of sum_t ||y_t - (p_t + R_t m)||^2 + reg ||D (m - m0)||^2.

    R_t is orthonormal, so the objective decouples per coordinate:
    m_hat = (g + reg D m0) / (T + reg D) with g = sum_t R_t^T (y_t - p_t).

    p_all (T, K, 3) and R_all (T, K, 3, 3) are the parent-body frames of the
    keypoint sites, y (T, K, 3) the observed keypoints, D = is_regularized.
    """
    dtype = y.dtype
    mask = is_regularized.to(dtype)
    resid = y - p_all
    g = torch.einsum("tkji,tkj->ki", R_all, resid)
    sq_total = torch.sum(resid * resid)
    n_frames = float(y.shape[0])

    anchor = reg_coef * mask
    m_hat = (g + anchor * initial_offsets) / (n_frames + anchor)
    fit_term = sq_total - 2.0 * torch.sum(m_hat * g) + n_frames * torch.sum(m_hat * m_hat)
    penalty = reg_coef * torch.sum((mask * (m_hat - initial_offsets)) ** 2)
    return MOptResult(params=m_hat, error=fit_term + penalty)
