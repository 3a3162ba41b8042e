"""The port's flat Levenberg-Marquardt IK against the JAX package's GNIK on
the firstparty model: the Jacobian, ``solve_batch`` (both damping rules,
shared and per-item masks, a maxiter override) and the single-frame
``solve``, in float64; the final loss in float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import x64_mode
from _torch_common import bridge, jax_stac
from stac_mjx_tpu.models.builder import extract_model
from stac_mjx_tpu.ops.gn_ik import GNIK as JaxGNIK
from stac_mjx_tpu_torch.ops.gn_ik import GNIK
from stac_mjx_tpu_torch.ops.stac_core import StacCore

F = 16


@pytest.fixture(scope="module")
def problem():
    """16 lanes: kp from FK of random poses, starts perturbed from them."""
    js = jax_stac({})
    b = bridge.load_bundle()
    rng = np.random.default_rng(0)
    q_true = np.tile(b["qpos0"], (F, 1)) + rng.normal(0, 0.3, (F, 44))
    q0 = q_true + rng.normal(0, 0.15, (F, 44))
    with x64_mode():
        _, p64 = extract_model(js._mj_model, dtype=jnp.float64)
        fk = JaxGNIK(js.topo, js._body_site_idxs, fk_impl="jump", linesearch=False).fk
        kp = np.array(
            jax.vmap(lambda q: fk(p64, q).site_xpos[js._body_site_idxs].reshape(-1))(jnp.asarray(q_true))
        )
    per_item = rng.uniform(size=(F, 44)) > 0.3
    return dict(js=js, b=b, p64=p64, kp=kp, q0=q0, per_item=per_item)


def _jax_gnik(js, rule="nielsen"):
    return JaxGNIK(js.topo, js._body_site_idxs, maxiter=14, fk_impl="jump",
                   linesearch=False, spd_impl="xla", damping_rule=rule)


def _port(b, dtype, rule="nielsen"):
    fm = bridge.fit_model_from_arrays(b, "cpu", dtype)
    lb, ub = (torch.as_tensor(b[k]).to(dtype) for k in ("lb", "ub"))
    return GNIK(fm.topo, fm.site_idxs, "cpu", maxiter=14, damping_rule=rule), fm.params, lb, ub


def test_jacobian_matches_jax_f64(problem):
    js, b, p64 = problem["js"], problem["b"], problem["p64"]
    jg = _jax_gnik(js)
    with x64_mode():
        want = np.asarray(jax.vmap(lambda q: jg.jacobian(jg.fk(p64, q)))(jnp.asarray(problem["q0"])))
    tg, params, _, _ = _port(b, torch.float64)
    got = tg.jacobian(tg.fk(params, torch.as_tensor(problem["q0"])))
    assert got.shape == (F, 69, 37)
    # The same cross products of the same FK outputs.
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


@pytest.mark.parametrize(
    "rule,mask,maxiter",
    [("nielsen", "shared", None), ("nielsen", "per_item", 5), ("fixed", "shared", 5), ("fixed", "per_item", None)],
)
def test_solve_batch_matches_jax_f64(problem, rule, mask, maxiter):
    js, b, p64 = problem["js"], problem["b"], problem["p64"]
    qs = np.ones(44, bool) if mask == "shared" else problem["per_item"]
    kps = np.ones(69)
    kp, q0 = problem["kp"], problem["q0"]
    jg = _jax_gnik(js, rule)
    with x64_mode():
        lb, ub = jnp.asarray(b["lb"]), jnp.asarray(b["ub"])
        jr = jax.jit(
            lambda k, q: jg.solve_batch(p64, k, jnp.asarray(qs), jnp.asarray(kps), q, lb, ub, maxiter=maxiter)
        )(jnp.asarray(kp), jnp.asarray(q0))
        jr = jax.device_get(jr)
    tg, params, lb_t, ub_t = _port(b, torch.float64, rule)
    tr = tg.solve_batch(params, torch.as_tensor(kp), torch.as_tensor(qs), torch.as_tensor(kps),
                        torch.as_tensor(q0), lb_t, ub_t, maxiter=maxiter)
    # Same accept pattern in every lane, so the iterates differ by float64
    # rounding only (measured <= 5e-12 in q, 1e-11 relative in lambda).
    np.testing.assert_allclose(tr.params.numpy(), jr.params, rtol=0, atol=1e-9)
    lam_t, lam_j = 1 / tr.stepsize.numpy() - 1, 1 / jr.stepsize - 1
    np.testing.assert_allclose(lam_t, lam_j, rtol=1e-8)
    np.testing.assert_allclose(tr.value.numpy(), jr.value, rtol=1e-9, atol=1e-15)
    np.testing.assert_allclose(tr.error.numpy(), jr.error, rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(tr.iters.numpy(), jr.iters)
    if mask == "per_item":  # masked coordinates keep their starting values
        qp = tr.params.numpy()
        q0p = np.where(tg._clip_mask.numpy(), np.clip(q0, b["lb"], b["ub"]), q0)
        quat_free = ~tg._clip_mask.numpy()
        hold = ~qs & ~quat_free[None]
        np.testing.assert_array_equal(qp[hold], q0p[hold])


def test_single_frame_solve_matches_jax_f64(problem):
    """GNIK.solve's flat LM (the fit's root solve): fixed x10/x0.2 damping,
    lambda added into A. Root dofs against the trunk keypoints."""
    js, b, p64 = problem["js"], problem["b"], problem["p64"]
    qs = np.zeros(44, bool)
    qs[:7] = True
    kps = np.repeat(b["trunk_kps"], 3).astype(np.float64)
    kp, q0 = problem["kp"][0], problem["q0"][0]
    jg = _jax_gnik(js)
    with x64_mode():
        lb, ub = jnp.asarray(b["lb"]), jnp.asarray(b["ub"])
        jr = jax.device_get(
            jax.jit(lambda k, q: jg.solve(p64, k, jnp.asarray(qs), jnp.asarray(kps), q, lb, ub))(
                jnp.asarray(kp), jnp.asarray(q0)
            )
        )
    tg, params, lb_t, ub_t = _port(b, torch.float64)
    tr = tg.solve(params, torch.as_tensor(kp), torch.as_tensor(qs), torch.as_tensor(kps),
                  torch.as_tensor(q0), lb_t, ub_t)
    assert tr.params.shape == (44,) and tr.value.shape == ()
    # The solve converges within its 14 iterations; once converged, its
    # accept tests compare losses equal to rounding and the final lambda
    # follows that noise, so it is not compared. q: measured 7e-10.
    np.testing.assert_allclose(tr.params.numpy(), jr.params, rtol=0, atol=1e-8)
    np.testing.assert_allclose(float(tr.value), float(jr.value), rtol=1e-8)
    # Non-root scalar coordinates keep their box-projected starting values
    # (the retraction renormalizes every quaternion, masked or not).
    scalar = tg._clip_mask.numpy()
    scalar[:7] = False
    np.testing.assert_array_equal(tr.params.numpy()[scalar], np.clip(q0, b["lb"], b["ub"])[scalar])


def test_solve_batch_final_loss_f32(problem):
    """float32 can flip accept branches, so the lanes are held by their
    final loss: each within 1.5x of JAX's float32 loss (+ the float32 noise
    floor of a ~70-residual sum, 1e-10 m^2)."""
    js, b = problem["js"], problem["b"]
    kp, q0 = problem["kp"].astype(np.float32), problem["q0"].astype(np.float32)
    kps = np.ones(69, np.float32)
    qs = np.ones(44, bool)
    fm32 = extract_model(js._mj_model, dtype=jnp.float32)[1]
    jg = _jax_gnik(js)
    jr = jax.device_get(
        jax.jit(lambda k, q: jg.solve_batch(fm32, k, jnp.asarray(qs), jnp.asarray(kps), q,
                                            jnp.asarray(b["lb"], jnp.float32), jnp.asarray(b["ub"], jnp.float32)))(
            jnp.asarray(kp), jnp.asarray(q0)
        )
    )
    tg, params, lb_t, ub_t = _port(b, torch.float32)
    tr = tg.solve_batch(params, torch.as_tensor(kp), torch.as_tensor(qs), torch.as_tensor(kps),
                        torch.as_tensor(q0), lb_t, ub_t)
    got, want = tr.value.numpy(), np.asarray(jr.value)
    assert np.isfinite(got).all()
    assert (got <= 1.5 * want + 1e-10).all(), np.c_[got, want]
    assert got.sum() <= 1.1 * want.sum() + 1e-9


def test_unported_options_raise():
    b = bridge.load_bundle()
    fm = bridge.fit_model_from_arrays(b, "cpu")
    for kw in ({"q_solver": "pg"}, {"q_solver": "pg-jaxopt"}, {"q_solver": "gn"},
               {"fk_impl": "scan"}, {"gn_stall_iters": 3}):
        with pytest.raises(NotImplementedError):
            StacCore(fm.topo, fm.site_idxs, "cpu", **kw)
    core = StacCore(fm.topo, fm.site_idxs, "cpu")
    assert core.gnik.maxiter == 14
    assert StacCore(fm.topo, fm.site_idxs, "cpu", gn_damping_rule="fixed").gnik.maxiter == 16
    assert StacCore(fm.topo, fm.site_idxs, "cpu", n_iter_q=5).gnik.maxiter == 5
