"""Batches of SPD systems for the port's SPD tests and ``chip_smoke.py``.

Imports only numpy and torch, so it serves the card-side tests and the smoke
run on the GPU machine, where jax is absent.
"""

from __future__ import annotations

import numpy as np
import torch


def spd_systems(F, n, gen, device, chunk=20_000):
    """Random float32 J^T J + 1e-4 I systems (as the LM builds them), right-hand
    sides and damping, drawn from ``gen`` on ``device``. Returns (A, g, lam).
    J is drawn ``chunk`` systems at a time, so that it fits beside A at the
    largest F (the same draws as in one piece up to ``chunk``)."""
    A = torch.empty(F, n, n, device=device)
    for lo in range(0, F, chunk):
        J = torch.randn(min(chunk, F - lo), 2 * n, n, generator=gen, device=device)
        A[lo:lo + chunk] = J.mT @ J + 1e-4 * torch.eye(n, device=device)
        del J
    g = torch.randn(F, n, generator=gen, device=device)
    lam = torch.rand(F, generator=gen, device=device)
    return A, g, lam


def indefinite_batch(F, n, seed):
    """F float64 SPD systems, except the middle one: L0 D L0^T with L0 unit
    lower-triangular and D = 1 but -1 at column n // 2, so its Cholesky
    pivots are D and the factor fails at a column > 0. Returns (A, g, mid)."""
    rng = np.random.default_rng(seed)
    J = rng.normal(size=(F, 2 * n, n))
    A = np.einsum("frd,fre->fde", J, J) + 1e-4 * np.eye(n)
    L0 = np.tril(0.3 * rng.normal(size=(n, n)), -1) + np.eye(n)
    D = np.ones(n)
    D[n // 2] = -1.0
    A[F // 2] = L0 @ np.diag(D) @ L0.T
    return A, rng.normal(size=(F, n)), F // 2


def fixed_systems(F, n, seed):
    """(A, g, lam) as ``spd_systems`` builds them, drawn with numpy from
    ``seed`` on the CPU in float64 and rounded to float32: the same bits on
    every machine, for checks of a kernel's exact output."""
    rng = np.random.default_rng(seed)
    J = rng.standard_normal((F, 2 * n, n))
    A = np.einsum("frd,fre->fde", J, J) + 1e-4 * np.eye(n)
    g = rng.standard_normal((F, n))
    lam = rng.uniform(size=F)
    return tuple(torch.as_tensor(a.astype(np.float32)) for a in (A, g, lam))
