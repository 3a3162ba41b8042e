"""Lane semantics: the port's solvers over a batch of lanes against
``jax.vmap`` of the JAX package's single-frame solvers, in float64 on the
CPU. Each lane must take the iterations its JAX lane takes, and a finished
lane must stay bitwise frozen while the others go on (``utils.lanes``)."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import x64_mode
from _torch_common import bridge, jax_stac
from stac_mjx_tpu.models.builder import extract_model
from stac_mjx_tpu.ops.gn_ik import GNIK as JaxGNIK
from stac_mjx_tpu.ops.solver import ProjectedGradient as JaxPG
from stac_mjx_tpu_torch.ops import gn_ik, solver
from stac_mjx_tpu_torch.ops.gn_ik import GNIK
from stac_mjx_tpu_torch.ops.stac_core import StacCore
from stac_mjx_tpu_torch.utils.lanes import while_lanes

B = 6
SIGMAS = (0.002, 0.005, 0.01, 0.02, 0.05, 0.01)  # start perturbations: lanes converge apart


def test_while_lanes_freezes_finished_lanes():
    """The body runs while any lane is active, on every lane; inactive lanes
    keep their state bitwise (here the body would turn them into NaN)."""
    limit = torch.tensor([0, 3, 1, 5])
    calls = []

    def cond(s):
        return s[0] < limit

    def body(s, active):
        calls.append(active.clone())
        k, x = s
        return k + 1, torch.where(active, x + 0.5, torch.nan)

    k, x = while_lanes(cond, body, (torch.zeros(4, dtype=torch.long), torch.full((4,), 0.25)))
    assert k.tolist() == [0, 3, 1, 5]
    assert x.tolist() == [0.25, 1.75, 0.75, 2.75]
    assert len(calls) == 5 and calls[0].tolist() == [False, True, True, True]


@contextlib.contextmanager
def recording(module, n_state):
    """Snapshots of every state a ``while_lanes`` loop of n_state tensors in
    ``module`` checks its condition on, with the mask it got."""
    steps = []
    orig = module.while_lanes

    def recorded(cond, body, state):
        if len(state) != n_state:
            return orig(cond, body, state)

        def cond_rec(s):
            active = cond(s)
            steps.append(([t.clone() for t in s], active.clone()))
            return active

        return orig(cond_rec, body, state)

    module.while_lanes = recorded
    try:
        yield steps
    finally:
        module.while_lanes = orig


def assert_frozen(steps, final):
    """Once a lane's condition fails, every later state of that lane (and the
    result) is bitwise the state it finished with."""
    n_frozen = 0
    for lane in range(steps[0][1].shape[0]):
        done = [i for i, (_, active) in enumerate(steps) if not active[lane]]
        if not done:
            continue
        n_frozen += 1
        at = steps[done[0]][0]
        for state, _ in steps[done[0] :]:
            for a, b in zip(state, at):
                assert torch.equal(a[lane], b[lane]) or (torch.isnan(a[lane]).all() and torch.isnan(b[lane]).all())
        for a, b in zip(final, at):
            np.testing.assert_array_equal(a[lane].numpy(), b[lane].numpy())
    return n_frozen


@pytest.fixture(scope="module")
def lanes():
    """B firstparty frames (kp from the FK of random poses), starts perturbed
    by SIGMAS; the last lane's keypoints are NaN."""
    js = jax_stac({"fk_impl": "jump"})
    b = bridge.load_bundle()
    rng = np.random.default_rng(0)
    q_true = b["qpos0"] + rng.normal(0, 0.2, (B, 44))
    q0 = q_true + rng.normal(size=(B, 44)) * np.array(SIGMAS)[:, None]
    core = js.stac_core_obj
    with x64_mode():
        _, p64 = extract_model(js._mj_model, dtype=jnp.float64)
        kp = np.array(jax.vmap(lambda q: core.fk(p64, q).site_xpos[js._body_site_idxs].reshape(-1))(jnp.asarray(q_true)))
    kp[-1, 6] = np.nan
    per_item = rng.uniform(size=(B, 44)) > 0.3
    fm = bridge.fit_model_from_arrays(b, "cpu", torch.float64)
    return dict(js=js, b=b, p64=p64, kp=kp, q0=q0, fm=fm, per_item=per_item)


def _bounds(b, jax_side):
    if jax_side:
        return jnp.asarray(b["lb"]), jnp.asarray(b["ub"])
    return torch.as_tensor(b["lb"]), torch.as_tensor(b["ub"])


@pytest.mark.parametrize("jaxopt_mode", [False, True], ids=["pg", "pg-jaxopt"])
def test_projected_gradient_lanes_match_vmap(lanes, jaxopt_mode):
    b, kp, q0, p64 = lanes["b"], lanes["kp"], lanes["q0"], lanes["p64"]
    core = lanes["js"].stac_core_obj
    qs, kps = np.ones(44, bool), np.ones(69)
    maxiter, tol = 80, 1e-2
    with x64_mode():
        pg = JaxPG(maxiter=maxiter, tol=tol, jaxopt_mode=jaxopt_mode)
        lb, ub = _bounds(b, True)

        def one(k, q):
            return pg.run(lambda x: core.q_loss(x, p64, k, jnp.asarray(qs), jnp.asarray(kps), q), q, lb, ub)

        want = jax.device_get(jax.jit(jax.vmap(one))(jnp.asarray(kp), jnp.asarray(q0)))
    fm = lanes["fm"]
    tcore = StacCore(fm.topo, fm.site_idxs, "cpu", fk_impl="jump")
    kp_t, q0_t = torch.as_tensor(kp), torch.as_tensor(q0)
    with recording(solver, 7) as steps:
        got = solver.ProjectedGradient(maxiter=maxiter, tol=tol, jaxopt_mode=jaxopt_mode).run(
            lambda x: tcore.q_loss(x, fm.params, kp_t, torch.as_tensor(qs), torch.as_tensor(kps), q0_t),
            q0_t, *_bounds(b, False),
        )
    np.testing.assert_array_equal(got.iters.numpy(), want.iters)
    if not jaxopt_mode:
        assert len(set(want.iters.tolist())) >= 4, want.iters  # lanes finish apart
    assert want.iters[-1] == 1  # the NaN lane keeps its start and ends
    np.testing.assert_allclose(got.params.numpy(), want.params, rtol=0, atol=1e-9)
    for f in ("value", "error", "stepsize"):
        np.testing.assert_allclose(getattr(got, f).numpy(), getattr(want, f), rtol=1e-9, atol=1e-15, err_msg=f)
    # The loop's last check is on the state it returns.
    np.testing.assert_array_equal(steps[-1][0][1].numpy(), got.params.numpy())
    assert assert_frozen(steps, steps[-1][0]) >= (1 if jaxopt_mode else B)


@pytest.mark.parametrize("mask", ["shared", "per_item"])
def test_gn_linesearch_lanes_match_vmap(lanes, mask):
    """GNIK.solve's linesearch branch (q_solver="gn") over lanes."""
    b, kp, q0, p64, js = lanes["b"], lanes["kp"][:-1], lanes["q0"][:-1], lanes["p64"], lanes["js"]
    qs = np.ones(44, bool) if mask == "shared" else lanes["per_item"][:-1]
    kps = np.ones(69)
    jg = JaxGNIK(js.topo, js._body_site_idxs, maxiter=16, tol=1e-8, fk_impl="jump", linesearch=True,
                 spd_impl="xla")
    with x64_mode():
        lb, ub = _bounds(b, True)
        axes = (0, 0, 0 if mask == "per_item" else None)
        want = jax.device_get(jax.jit(jax.vmap(
            lambda k, q, m: jg.solve(p64, k, m, jnp.asarray(kps), q, lb, ub), in_axes=axes
        ))(jnp.asarray(kp), jnp.asarray(q0), jnp.asarray(qs)))
    fm = lanes["fm"]
    tg = GNIK(fm.topo, fm.site_idxs, "cpu", maxiter=16, tol=1e-8, linesearch=True)
    with recording(gn_ik, 5) as steps:
        got = tg.solve(fm.params, torch.as_tensor(kp), torch.as_tensor(qs), torch.as_tensor(kps),
                       torch.as_tensor(q0), *_bounds(b, False))
    np.testing.assert_array_equal(got.iters.numpy(), want.iters)
    assert len(set(want.iters.tolist())) >= 2, want.iters
    np.testing.assert_allclose(got.params.numpy(), want.params, rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.value.numpy(), want.value, rtol=1e-9, atol=1e-15)
    np.testing.assert_allclose(got.stepsize.numpy(), want.stepsize, rtol=1e-9)
    np.testing.assert_allclose(got.error.numpy(), want.error, rtol=1e-9)
    outer = [st for st in steps if st[0][2].ndim == 1]  # (k, q, lam, ...), not the linesearch's
    np.testing.assert_array_equal(outer[-1][0][1].numpy(), got.params.numpy())
    assert assert_frozen(outer, outer[-1][0]) == len(kp)


def test_flat_lm_lanes_match_vmap(lanes):
    """GNIK.solve's flat LM (gn-lm in sequential mode) over lanes with a mask
    per lane: the fixed damping rule, lambda added into A, a fixed count."""
    b, kp, q0, p64, js = lanes["b"], lanes["kp"][:-1], lanes["q0"][:-1], lanes["p64"], lanes["js"]
    qs, kps = lanes["per_item"][:-1], np.ones(69)
    jg = JaxGNIK(js.topo, js._body_site_idxs, maxiter=14, fk_impl="jump", linesearch=False, spd_impl="xla")
    with x64_mode():
        lb, ub = _bounds(b, True)
        want = jax.device_get(jax.jit(jax.vmap(
            lambda k, q, m: jg.solve(p64, k, m, jnp.asarray(kps), q, lb, ub)
        ))(jnp.asarray(kp), jnp.asarray(q0), jnp.asarray(qs)))
    fm = lanes["fm"]
    tg = GNIK(fm.topo, fm.site_idxs, "cpu", maxiter=14)
    got = tg.solve(fm.params, torch.as_tensor(kp), torch.as_tensor(qs), torch.as_tensor(kps),
                   torch.as_tensor(q0), *_bounds(b, False))
    np.testing.assert_array_equal(got.iters.numpy(), want.iters)
    np.testing.assert_allclose(got.params.numpy(), want.params, rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.value.numpy(), want.value, rtol=1e-9, atol=1e-15)


@pytest.mark.parametrize("q_solver", ["pg-jaxopt", "gn"])
def test_q_opt_batch_routes_single_frame_solves(lanes, q_solver):
    """StacCore.q_opt_batch: only gn-lm has a batched solver; pg, pg-jaxopt
    and gn run their single-frame solve on every item (the JAX version's
    vmap), here with a mask per item."""
    b, kp, q0, p64 = lanes["b"], lanes["kp"][:-1], lanes["q0"][:-1], lanes["p64"]
    qs, kps = lanes["per_item"][:-1], np.ones(69)
    js = jax_stac({"q_solver": q_solver, "fk_impl": "jump"}, {"N_ITER_Q": 30})
    core = js.stac_core_obj
    with x64_mode():
        lb, ub = _bounds(b, True)
        want = jax.device_get(jax.jit(
            lambda k, q, m: core.q_opt_batch(p64, k, m, jnp.asarray(kps), q, lb, ub)
        )(jnp.asarray(kp), jnp.asarray(q0), jnp.asarray(qs)))
    fm = lanes["fm"]
    tcore = StacCore(fm.topo, fm.site_idxs, "cpu", tol=1e-4, n_iter_q=30, q_solver=q_solver, fk_impl="jump")
    got = tcore.q_opt_batch(fm.params, torch.as_tensor(kp), torch.as_tensor(qs), torch.as_tensor(kps),
                            torch.as_tensor(q0), *_bounds(b, False))
    np.testing.assert_array_equal(got.iters.numpy(), want.iters)
    np.testing.assert_allclose(got.params.numpy(), want.params, rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.value.numpy(), want.value, rtol=1e-9, atol=1e-15)
