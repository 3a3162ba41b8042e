"""The port's sequential pose mode against the JAX package, in float64 on
the CPU: the fit (root solve with two passes, N_ITERS=1 x (pose pass,
m-phase), final pass; each frame a full-q solve then the six part solves,
frame t starting from frame t-1) and the per-clip ik, for pg-jaxopt and for
gn-lm (whose single-frame solve is the flat LM with the fixed damping rule),
on firstparty with the pointer-doubling FK and N_ITER_Q lowered to 20.
The JAX side runs through ``_torch_common.JaxSequential``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import x64_mode
from _torch_common import JaxSequential, assert_same_static_cfg, bridge, jax_stac, np64, torch_stac
from stac_mjx_tpu.models import firstparty as jfirstparty
from stac_mjx_tpu.models.builder import extract_model
from stac_mjx_tpu_torch import pipeline as tpipe

MODEL = {"N_ITERS": 1, "N_ITER_Q": 20}
F = 4  # fit frames, and frames per ik clip


@pytest.fixture(scope="module")
def recording():
    js = jax_stac({})
    kp, _, _, _ = jfirstparty.make_recording(js.cfg, n_frames=3 * F, seed=3, base_path=".")
    return np.asarray(kp, np.float32).astype(np.float64)


@pytest.mark.parametrize("q_solver", ["pg-jaxopt", "gn-lm"])
def test_sequential_fit_and_ik_match_jax_f64(recording, q_solver):
    cfg = {"q_solver": q_solver, "fk_impl": "jump", "n_frames_per_clip": F}
    js = jax_stac(cfg, MODEL)
    b = bridge.load_bundle()
    assert js._static_cfg.pose_mode == "sequential" and js._static_cfg.root_opt_passes == 2
    kp, bk = recording[:F], recording[F:].reshape(2, F, -1)
    with x64_mode():
        _, p64 = extract_model(js._mj_model, dtype=jnp.float64)
        jseq = JaxSequential(js, p64, jnp.asarray(b["lb"]), jnp.asarray(b["ub"]),
                             jnp.asarray(b["is_regularized"]))
        jfit = jseq.fit(jnp.asarray(kp))
        jq, je = jseq.ik(jnp.asarray(bk), jnp.asarray(jfit["offsets"]))
    ts = torch_stac(cfg, MODEL, torch.float64)
    assert_same_static_cfg(ts._static_cfg, js._static_cfg)
    tfit = tpipe.fit_offsets_program(ts.stac_core_obj, ts._static_cfg, ts.params, torch.as_tensor(kp),
                                     ts._lb, ts._ub, ts._is_regularized, return_full=False)
    tq, te = tpipe.ik_only_program(ts.stac_core_obj, ts._static_cfg, ts.params, torch.as_tensor(bk),
                                   torch.as_tensor(jfit["offsets"]), ts._lb, ts._ub, return_full=False)
    # Measured: pg-jaxopt 2e-15 in qpos (the same iterates); gn-lm 4e-8 in
    # qpos and 9e-11 m in the offsets (float64 rounding through the flat
    # LM's accept tests). Bounds: qpos 1e-6, marker-space 1e-9 m.
    for k in ("offsets", "frame_error", "iter_frame_errors", "iter_m_errors"):
        np.testing.assert_allclose(np64(tfit[k]), jfit[k], rtol=0, atol=1e-9, err_msg=k)
    np.testing.assert_allclose(np64(tfit["qpos"]), jfit["qpos"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(np64(tq), jq, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np64(te), je, rtol=0, atol=1e-9)
