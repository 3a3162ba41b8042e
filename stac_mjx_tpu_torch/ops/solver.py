"""Box-constrained solvers for the q-phase and the closed-form m-phase
(port of ``stac_mjx_tpu/ops/solver.py``).

``ProjectedGradient`` is FISTA with a backtracking line search, run over a
batch of independent lanes with the semantics the JAX version has under
``jax.vmap`` (``utils.lanes.while_lanes``): each lane stops on its own
tolerance or iteration cap and stays frozen while the others go on. The
gradient is ``torch.autograd.grad`` of the lanes' summed loss, which is each
lane's own gradient because the lanes are independent.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from stac_mjx_tpu_torch.utils.lanes import while_lanes
from stac_mjx_tpu_torch.utils.profiling import annotate


class PGResult(NamedTuple):
    """Result of a box-constrained pose solve.

    ``value`` is the masked SSE loss at the final iterate; ``error`` is the
    solver's own diagnostic: the fixed-point residual for pg/pg-jaxopt, the
    accepted step's norm for gn, sqrt of the loss for gn-lm; ``stepsize`` is
    1 / (1 + lambda) for the Gauss-Newton solvers. Every field has the lane
    axis first (``iters`` is per lane).
    """

    params: torch.Tensor  # final iterate (full q vector, box-projected)
    error: torch.Tensor
    value: torch.Tensor
    iters: torch.Tensor
    stepsize: torch.Tensor


def project_box(x: torch.Tensor, lb: torch.Tensor, ub: torch.Tensor) -> torch.Tensor:
    """Euclidean projection onto [lb, ub] (jaxopt projection_box semantics)."""
    return torch.clamp(x, lb, ub)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def value_and_grad(fun: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor):
    """(fun(x), its gradient) for a loss of independent lanes, x (B, n) -> (B,)."""
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        f = fun(x)
        (g,) = torch.autograd.grad(f.sum(), x)
    return f.detach(), g


def graph_replay(fn: Callable, example: torch.Tensor) -> Callable:
    """``fn`` captured once into a CUDA graph for inputs shaped like
    ``example`` and replayed on each call (outputs cloned).

    A loss evaluation of the scan FK is some 10^3 small kernels, each
    dispatched from the host in eager mode; a replay issues them all at once.
    The kernels are the same, so are the results. ``fn`` must take and
    return tensors only and make no host sync. Spans that ``fn`` opens
    record at the capture only: a replay runs no Python.
    """
    device = example.device
    static_x = example.detach().clone()
    with torch.cuda.device(device), annotate("pg.capture"):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm up allocator and autograd off the capture
            for _ in range(2):
                fn(static_x)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static_out = fn(static_x)

    def replay(x: torch.Tensor):
        static_x.copy_(x)
        with annotate("pg.replay"):
            graph.replay()
            if isinstance(static_out, tuple):
                return tuple(o.clone() for o in static_out)
            return static_out.clone()

    return replay


@dataclasses.dataclass(frozen=True)
class ProjectedGradient:
    """FISTA projected gradient with backtracking line search.

    Fields as in the JAX version: ``maxiter`` (N_ITER_Q), ``tol`` (FTOL),
    ``maxls`` backtracking steps, ``decrease_factor``, ``init_stepsize``,
    ``acceleration``; ``jaxopt_mode`` selects the jaxopt-0.8.5 iteration
    (the parity numerics), and each of the five deviation flags, when not
    None, overrides the one way it differs from the robust default.
    On the card the loss and its gradient replay from CUDA graphs
    (``graph_replay``); the iteration is the same as the CPU's eager one.
    """

    maxiter: int = 400
    tol: float = 1e-5
    maxls: int = 15
    decrease_factor: float = 0.5
    init_stepsize: float = 1.0
    acceleration: bool = True
    jaxopt_mode: bool = False
    ls_slack: bool | None = None  # eps rounding slack in the decrease test
    reordered_test: bool | None = None  # jaxopt's multiply-through form
    monotone_stepsize: bool | None = None  # shrink-only + underflow reset
    error_from_x: bool | None = None  # error anchored at x_prev (vs y)
    adaptive_restart: bool | None = None  # O'Donoghue-Candes restart

    def _resolved(self):
        """The five deviation flags, resolved against jaxopt_mode."""
        j = self.jaxopt_mode

        def pick(v, jaxopt_val):
            return jaxopt_val if v is None else v

        return (
            pick(self.ls_slack, not j),
            pick(self.reordered_test, j),
            pick(self.monotone_stepsize, j),
            pick(self.error_from_x, j),
            pick(self.adaptive_restart, not j),
        )

    def run(
        self,
        fun: Callable[[torch.Tensor], torch.Tensor],
        x0: torch.Tensor,
        lb: torch.Tensor,
        ub: torch.Tensor,
    ) -> PGResult:
        """Minimize each lane of ``fun`` over the box [lb, ub] from x0 (B, n).

        ``fun`` maps (B, n) to (B,) losses of independent lanes. The default
        policy (robust float32) has an eps slack in the sufficient-decrease
        test, one notch of stepsize recovery per iteration and adaptive
        restart; ``jaxopt_mode`` has jaxopt's reordered test without slack, a
        monotone stepsize reset to 1.0 below 1e-6, plain FISTA momentum and
        the error anchored at the previous iterate.
        """
        dtype = x0.dtype
        B = x0.shape[0]
        use_slack, reordered_test, monotone_stepsize, error_from_x, restart_on = self._resolved()
        # Candidate budget: the carried stepsize plus maxls shrinks in
        # jaxopt_mode; maxls candidates in all otherwise.
        ls_bound = self.maxls + 1 if self.jaxopt_mode else self.maxls

        def linesearch(y, f_y, g_y, stepsize, outer_active):
            """Backtrack from ``stepsize`` until sufficient decrease holds."""
            if use_slack:
                # Near the optimum f_next and the quadratic bound agree to
                # within float eps; without slack float32 rejects good steps.
                eps = 2.0 * torch.finfo(dtype).eps * (1.0 + torch.abs(f_y))
            else:
                eps = torch.zeros_like(f_y)

            def make_step(ss):
                x_next = project_box(y - ss[:, None] * g_y, lb, ub)
                diff = x_next - y
                f_next = fun(x_next)
                if reordered_test:
                    lhs = ss * (f_next - f_y)
                    rhs = ss * _dot(diff, g_y) + 0.5 * _dot(diff, diff)
                    ok = lhs <= rhs + eps * ss
                else:
                    q_bound = f_y + _dot(g_y, diff) + _dot(diff, diff) / (2.0 * ss)
                    ok = f_next <= q_bound + eps
                return x_next, f_next, ok

            def cond(s):
                ls_iter, _, _, _, ok = s
                return ~ok & (ls_iter < ls_bound) & outer_active

            def body(s, _active):
                ls_iter, ss, _, _, _ = s
                ss = torch.where(ls_iter > 0, ss * self.decrease_factor, ss)
                x_next, f_next, ok = make_step(ss)
                return ls_iter + 1, ss, x_next, f_next, ok

            x_init, f_init, ok0 = make_step(stepsize)
            one = torch.ones(B, dtype=torch.int32, device=x0.device)
            _, ss, x_next, f_next, _ = while_lanes(cond, body, (one, stepsize, x_init, f_init, ok0))
            return x_next, f_next, ss

        def vg(y):
            return value_and_grad(fun_eager, y)

        def cond(s):
            k, _, _, _, _, err, _ = s
            return (k < self.maxiter) & (err > self.tol)

        def body(s, active):
            with annotate("pg.iter"):
                k, x, y, t, stepsize, err, f_x = s
                f_y, g_y = vg(y)
                if monotone_stepsize:
                    trial = torch.where(stepsize <= 1e-6, torch.ones_like(stepsize), stepsize)
                else:
                    trial = torch.clamp(stepsize / self.decrease_factor, max=self.init_stepsize)
                x_next, f_next, ss = linesearch(y, f_y, g_y, trial, active)
                anchor = x if error_from_x else y
                err_next = torch.linalg.vector_norm(x_next - anchor, dim=-1) / ss
                # Failure containment: a non-finite step (NaN keypoints, inf
                # loss) keeps the previous iterate and ends the lane.
                ok = torch.isfinite(f_next) & torch.isfinite(x_next).all(dim=-1)
                x_next = torch.where(ok[:, None], x_next, x)
                f_next = torch.where(ok, f_next, f_x)
                err_next = torch.where(ok, err_next, torch.zeros_like(err_next))
                if self.acceleration:
                    t_next = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
                    y_next = x_next + ((t - 1.0) / t_next)[:, None] * (x_next - x)
                    if restart_on:
                        # Adaptive restart: clear the momentum when it points
                        # against descent.
                        restart = _dot(y - x_next, x_next - x) > 0
                        t_next = torch.where(restart, torch.ones_like(t_next), t_next)
                        y_next = torch.where(restart[:, None], x_next, y_next)
                else:
                    t_next, y_next = t, x_next
                return k + 1, x_next, y_next, t_next, ss, err_next, f_next

        fun_eager = fun
        with torch.no_grad():
            if x0.is_cuda:
                vg = graph_replay(vg, x0)
                fun = graph_replay(fun_eager, x0)
            f0 = fun(x0)
            init = (
                torch.zeros(B, dtype=torch.int32, device=x0.device),
                x0,
                x0,
                torch.ones(B, dtype=dtype, device=x0.device),
                torch.full((B,), self.init_stepsize, dtype=dtype, device=x0.device),
                torch.full((B,), float("inf"), dtype=dtype, device=x0.device),
                f0,
            )
            k, x, _, _, stepsize, err, f_x = while_lanes(cond, body, init)
        return PGResult(params=x, error=err, value=f_x, iters=k, stepsize=stepsize)


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
    n_frames_total: int | None = None,
    group=None,
) -> MOptResult:
    """Exact minimizer of sum_t ||y_t - (p_t + R_t m)||^2 + reg ||D (m - m0)||^2.

    R_t is orthonormal, so the objective decouples per coordinate:
    m_hat = (g + reg D m0) / (T + reg D) with g = sum_t R_t^T (y_t - p_t).

    p_all (T, K, 3) and R_all (T, K, 3, 3) are the parent-body frames of the
    keypoint sites, y (T, K, 3) the observed keypoints, D = is_regularized.

    With a torch.distributed process ``group`` (the frame-sharded fit) the
    statistics g, sum ||r||^2 and the frame count are this rank's partial
    sums, all-reduced (SUM) in one collective, as the JAX version ``psum``s
    them over its mesh axis. ``n_frames_total`` overrides the frame count T.
    """
    dtype = y.dtype
    mask = is_regularized.to(dtype)
    resid = y - p_all
    g = torch.einsum("tkji,tkj->ki", R_all, resid)
    sq_total = torch.sum(resid * resid)
    n_frames = float(y.shape[0])
    if group is not None:
        stats = torch.cat([g.reshape(-1), sq_total[None], g.new_tensor([n_frames])])
        dist.all_reduce(stats, group=group)
        g, sq_total, n_frames = stats[:-2].reshape(g.shape), stats[-2], stats[-1]
    if n_frames_total is not None:
        n_frames = float(n_frames_total)

    anchor = reg_coef * mask
    m_hat = (g + anchor * initial_offsets) / (n_frames + anchor)
    fit_term = sq_total - 2.0 * torch.sum(m_hat * g) + n_frames * torch.sum(m_hat * m_hat)
    penalty = reg_coef * torch.sum((mask * (m_hat - initial_offsets)) ** 2)
    return MOptResult(params=m_hat, error=fit_term + penalty)
