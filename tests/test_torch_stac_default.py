"""The port's ``Stac`` with no solver keys against the JAX package's ``Stac``
with no overrides, in float64 on the CPU: the JAX package's default
configuration (sequential pose mode, projected gradient with the robust
policy, autograd through the level-scan FK, the six part passes chained, two
root passes, tol = FTOL), through the port's entry points. N_ITERS and
N_ITER_Q are cut to 1 and 20 for time; the JAX side runs through
``_torch_common.JaxSequential``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import x64_mode
from _torch_common import JaxSequential, assert_same_static_cfg, bridge, jax_stac, torch_stac
from stac_mjx_tpu.models import firstparty as jfirstparty
from stac_mjx_tpu.models.builder import extract_model

MODEL = {"N_ITERS": 1, "N_ITER_Q": 20}
F = 2  # fit frames, and frames per ik clip


@pytest.fixture(scope="module")
def runs():
    cfg = {"n_frames_per_clip": F}
    js = jax_stac(cfg, MODEL)
    ts = torch_stac(cfg, MODEL, torch.float64)
    b = bridge.load_bundle()
    kp, _, _, _ = jfirstparty.make_recording(js.cfg, n_frames=3 * F, seed=5, base_path=".")
    kp = np.asarray(kp, np.float32).astype(np.float64)
    with x64_mode():
        _, p64 = extract_model(js._mj_model, dtype=jnp.float64)
        jseq = JaxSequential(js, p64, jnp.asarray(b["lb"]), jnp.asarray(b["ub"]), jnp.asarray(b["is_regularized"]))
        jfit = jseq.fit(jnp.asarray(kp[:F]))
        jq, _ = jseq.ik(jnp.asarray(kp[F:].reshape(2, F, -1)), jnp.asarray(jfit["offsets"]))
    tfit = ts.fit_offsets(kp[:F])
    tik = ts.ik_only(kp[F:], tfit.offsets)
    return dict(js=js, ts=ts, jfit=jfit, jq=jq, tfit=tfit, tik=tik)


def test_default_configuration_resolves_like_jax(runs):
    js, ts = runs["js"], runs["ts"]
    assert_same_static_cfg(ts._static_cfg, js._static_cfg)
    sc, core = ts._static_cfg, ts.stac_core_obj
    assert (sc.pose_mode, sc.root_opt_passes, sc.part_opt_mode, len(sc.indiv_parts)) == ("sequential", 2, "sequential", 6)
    assert (core.q_solver, core.fk_impl, core.gnik) == ("pg", "scan", None)
    assert (core.solver.maxiter, core.solver.tol, core.solver.jaxopt_mode) == (
        js.stac_core_obj.solver.maxiter, js.stac_core_obj.solver.tol, False)


def test_default_fit_and_ik_match_jax_f64(runs):
    """The same iterates up to float64 rounding: measured 2e-16 m in the
    offsets, 1e-15 in the fit's qpos, 5e-15 in the ik's; bounds 1e-12."""
    jfit, tfit = runs["jfit"], runs["tfit"]
    np.testing.assert_allclose(tfit.offsets, jfit["offsets"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(tfit.qpos, jfit["qpos"], rtol=0, atol=1e-12)
    markers = tfit.marker_sites.reshape(F, -1, 3)
    kp = tfit.kp_data.reshape(F, -1, 3)
    np.testing.assert_allclose(np.linalg.norm(kp - markers, axis=-1).mean(-1), jfit["frame_error"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(runs["tik"].qpos, runs["jq"].reshape(-1, runs["jq"].shape[-1]), rtol=0, atol=1e-12)
