"""The damped SPD solve, plainly, in float64: x = (A + lam I)^-1 g for each
system of a batch, the function the program's batched Cholesky kernel
(K1) computes in float32.

Cholesky of each system in float64 (``torch.linalg.cholesky_ex``, then
``cholesky_solve``), NaN in x where the factorisation fails. Large batches
go through in blocks, so that the float64 copies fit beside the float32
originals. Imports nothing of the program under test.
"""

from __future__ import annotations

import torch


def spd_solve(A: torch.Tensor, g: torch.Tensor, lam: torch.Tensor | None = None,
              block: int = 8192) -> torch.Tensor:
    """x (F, n) float64 of A (F, n, n), g (F, n), lam (F,) or None."""
    F, n = g.shape
    eye = torch.eye(n, dtype=torch.float64, device=A.device)
    out = torch.empty(F, n, dtype=torch.float64, device=A.device)
    for lo in range(0, F, block):
        hi = min(F, lo + block)
        a = A[lo:hi].to(torch.float64)
        if lam is not None:
            a = a + lam[lo:hi].to(torch.float64)[:, None, None] * eye
        L, info = torch.linalg.cholesky_ex(a)
        x = torch.cholesky_solve(g[lo:hi].to(torch.float64)[..., None], L)[..., 0]
        out[lo:hi] = torch.where((info != 0)[:, None], torch.nan, x)
    return out


def relative_error(x: torch.Tensor, x_ref: torch.Tensor) -> float:
    """max |x - x_ref| / max |x_ref| over the batch, in float64."""
    x_ref = x_ref.to(torch.float64)
    return float((x.to(torch.float64) - x_ref).abs().max() / x_ref.abs().max())
