"""The synth model (one free body, one keypoint; the reference's CI smoke
workload) through the port's parity path: pg-jaxopt, sequential pose mode,
level-scan FK, part passes on, from the synth bundle. Held against the
recorded golden (``tests/goldens/synth.npz``, float32) at
``tests/test_parity.py``'s budgets, and against the JAX package live in
float64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import x64_mode
from _torch_common import REPO, JaxSequential, assert_same_static_cfg
from stac_mjx_tpu.config import compose_config
from stac_mjx_tpu.models.builder import extract_model
from stac_mjx_tpu.stac import Stac as JaxStac
from stac_mjx_tpu_torch.bridge import bundle_path, load_bundle
from stac_mjx_tpu_torch.stac import Stac

PARITY = {"q_solver": "pg-jaxopt", "pose_mode": "sequential", "fk_impl": "scan", "skip_part_opt": False}
# tests/test_parity.py's budgets for the synth golden's arrays.
TOL = {"fit_qpos": 1e-5, "fit_offsets": 1e-6, "fit_markers": 1e-6}


@pytest.fixture(scope="module")
def golden():
    return np.load(REPO / "tests" / "goldens" / "synth.npz")


def test_synth_golden(golden):
    """float32 on the CPU, as the golden was recorded. The port follows the
    same branches: measured max |delta| 0 in every array."""
    st = Stac(load_bundle(bundle_path("synth_data")), dict(PARITY, n_frames_per_clip=1), device="cpu")
    fit = st.fit_offsets(golden["fit_kp"])
    got = {"fit_qpos": fit.qpos, "fit_offsets": fit.offsets, "fit_markers": fit.marker_sites}
    for k, tol in TOL.items():
        assert got[k].shape == golden[k].shape, k
        assert float(np.abs(got[k] - golden[k]).max()) <= tol, k
    np.testing.assert_array_equal(fit.kp_data, golden["fit_kp"])


def test_synth_fit_matches_jax_f64(golden):
    overrides = ["model=synth_data", "stac=stac_synth_data"] + [f"stac.{k}={str(v).lower()}" for k, v in PARITY.items()]
    cfg = compose_config(REPO / "configs", overrides=overrides)
    js = JaxStac(REPO / "models" / "synth.xml", cfg, list(cfg.model.KEYPOINT_MODEL_PAIRS.keys()))
    b = load_bundle(bundle_path("synth_data"))
    st = Stac(b, dict(PARITY, n_frames_per_clip=1), device="cpu", dtype=torch.float64)
    assert_same_static_cfg(st._static_cfg, js._static_cfg)
    kp = golden["fit_kp"].astype(np.float64)
    with x64_mode():
        _, p64 = extract_model(js._mj_model, dtype=jnp.float64)
        want = JaxSequential(js, p64, jnp.asarray(b["lb"]), jnp.asarray(b["ub"]),
                             jnp.asarray(b["is_regularized"])).fit(jnp.asarray(kp))
    fit = st.fit_offsets(kp)
    # The same iteration in float64: measured max |delta| 0.
    np.testing.assert_allclose(fit.qpos, want["qpos"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(fit.offsets, want["offsets"], rtol=0, atol=1e-12)
