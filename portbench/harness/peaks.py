"""The yardstick: the H100's published peaks and the work that the pose
solve needs, counted from shapes.

Peaks: NVIDIA H100 SXM data sheet, dense, at the 700 W power limit; a card
set lower reads its limit beside every number (the result line's device).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12  # float32 outside the tensor cores


def spd_bound_s(F: int, n: int) -> float:
    """Least time (s) of F damped SPD solves of size n (A (F, n, n), g (F, n),
    lam (F,) -> x (F, n)): the lower triangle of A, g and lam read once and x
    written once, in float32, against n^3/3 + 2 n^2 operations per system;
    the larger of the two."""
    nbytes = F * 4 * (n * (n + 1) // 2 + 2 * n + 1)
    flops = F * (n**3 / 3 + 2 * n**2)
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S)


# Operations of one forward-kinematics pass, per body and per site: a
# quaternion product is 16 multiplies and 12 adds; a rotation of a vector by
# a quaternion (v + 2 (w u x v + u x (u x v))) 18 multiplies and 12 adds;
# a normalisation 4 multiplies, 3 adds, a root and 4 divides (12).
QMUL, QROT, QNORM = 28, 30, 12


def fk_flops(n_bodies: int, n_joints: int, n_sites: int) -> int:
    """One FK pass of one frame: per body its offset (a rotation, an add, a
    product) and normalisation, per joint its anchor and axis (two
    rotations, an add) and its turn (a product, a rotation, a subtraction),
    per site a rotation and an add."""
    return n_bodies * (QROT + 3 + QMUL + QNORM) + n_joints * (2 * QROT + 3 + QMUL + QROT + 3) + n_sites * (QROT + 3)


def lm_iteration_flops(m: int, n: int, n_bodies: int, n_joints: int, n_sites: int) -> float:
    """Useful float32 operations of one Levenberg-Marquardt iteration on one
    frame with m residual rows and n degrees of freedom: one FK pass (the
    trial pose), the analytic Jacobian (a cross product, 9 operations, per
    row triple and rotational dof), J'J (its lower triangle, m n (n + 1)
    multiply-adds), J'e (m n multiply-adds), and the damped Cholesky solve
    (n^3/3 + 2 n^2). Counted from shapes, whatever kernels run them."""
    jac = (m // 3) * n * 9
    return fk_flops(n_bodies, n_joints, n_sites) + jac + m * n * (n + 1) + 2 * m * n + n**3 / 3 + 2 * n**2
