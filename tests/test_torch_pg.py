"""The port's ``ProjectedGradient`` against the JAX package's on one
firstparty frame, in float64 on the CPU: the robust policy (``pg``), the
jaxopt-0.8.5 iteration (``pg-jaxopt``) and each of its five deviation flags
flipped alone. Same iteration count, q within 1e-9, value, error and
stepsize within 1e-9 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import x64_mode
from _torch_common import bridge, jax_stac
from stac_mjx_tpu.models.builder import extract_model
from stac_mjx_tpu.ops.solver import ProjectedGradient as JaxPG
from stac_mjx_tpu_torch.ops.solver import ProjectedGradient
from stac_mjx_tpu_torch.ops.stac_core import StacCore

FLAGS = ("ls_slack", "reordered_test", "monotone_stepsize", "error_from_x", "adaptive_restart")
# Each flag's value under jaxopt_mode (ops/solver.py::_resolved).
JAXOPT_VALUE = dict(ls_slack=False, reordered_test=True, monotone_stepsize=True, error_from_x=True,
                    adaptive_restart=False)
CASES = [("pg", {}), ("pg-jaxopt", {"jaxopt_mode": True})] + [
    (f"pg-jaxopt-{f}", {"jaxopt_mode": True, f: not JAXOPT_VALUE[f]}) for f in FLAGS
]
# pg stops on its tolerance after 45 iterations here, and so does pg-jaxopt
# with the error measured from y (54); the others run to the cap.
MAXITER, TOL = 100, 1e-2


@pytest.fixture(scope="module")
def frame():
    """One frame: kp from the FK of a random pose, the start perturbed from it."""
    js = jax_stac({"fk_impl": "jump"})
    b = bridge.load_bundle()
    rng = np.random.default_rng(0)
    q_true = b["qpos0"] + rng.normal(0, 0.2, 44)
    q0 = q_true + rng.normal(0, 0.01, 44)
    core = js.stac_core_obj
    with x64_mode():
        _, p64 = extract_model(js._mj_model, dtype=jnp.float64)
        kp = np.asarray(core.fk(p64, jnp.asarray(q_true)).site_xpos[js._body_site_idxs].reshape(-1))
    fm = bridge.fit_model_from_arrays(b, "cpu", torch.float64)
    return dict(js=js, b=b, p64=p64, kp=kp, q0=q0, fm=fm,
                tcore=StacCore(fm.topo, fm.site_idxs, "cpu", fk_impl="jump"))


@pytest.mark.parametrize("name,kw", CASES, ids=[c[0] for c in CASES])
def test_projected_gradient_matches_jax_f64(frame, name, kw):
    b, kp, q0 = frame["b"], frame["kp"], frame["q0"]
    qs, kps = np.ones(44, bool), np.ones(69)
    core, p64 = frame["js"].stac_core_obj, frame["p64"]
    with x64_mode():
        pg = JaxPG(maxiter=MAXITER, tol=TOL, **kw)
        lb, ub = jnp.asarray(b["lb"]), jnp.asarray(b["ub"])

        def run(k, q):
            return pg.run(lambda x: core.q_loss(x, p64, k, jnp.asarray(qs), jnp.asarray(kps), q), q, lb, ub)

        want = jax.device_get(jax.jit(run)(jnp.asarray(kp), jnp.asarray(q0)))
    tcore, fm = frame["tcore"], frame["fm"]
    kp_t, q0_t = torch.as_tensor(kp)[None], torch.as_tensor(q0)[None]
    got = ProjectedGradient(maxiter=MAXITER, tol=TOL, **kw).run(
        lambda x: tcore.q_loss(x, fm.params, kp_t, torch.as_tensor(qs), torch.as_tensor(kps), q0_t),
        q0_t, torch.as_tensor(b["lb"]), torch.as_tensor(b["ub"]),
    )
    assert int(got.iters[0]) == int(want.iters)
    np.testing.assert_allclose(got.params[0].numpy(), want.params, rtol=0, atol=1e-9)
    for f in ("value", "error", "stepsize"):
        np.testing.assert_allclose(float(getattr(got, f)[0]), float(getattr(want, f)), rtol=1e-9, err_msg=f)
