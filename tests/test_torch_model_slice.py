"""The slice as a whole: a firstparty config that no checked-in bundle serves
(every initial offset moved by a seeded +-3 mm per coordinate) compiled by
the port's builder (``bridge.bundle_for_config``), and the port's ``Stac``
built from it in float64 on the CPU fits 40 frames. Held against the JAX
``Stac`` on the same config (its pipeline on its own float64 model, jitted,
x64) with the bounds of ``test_torch_pipeline.py::test_fit_matches_jax_f64``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from conftest import x64_mode
from _torch_common import REPO, THROUGHPUT
from stac_mjx_tpu import pipeline as jpipe
from stac_mjx_tpu.config import compose_config as jax_compose_config
from stac_mjx_tpu.models.builder import extract_model
from stac_mjx_tpu.stac import Stac as JaxStac
from stac_mjx_tpu_torch import bridge
from stac_mjx_tpu_torch.config import compose_config
from stac_mjx_tpu_torch.models.firstparty import make_recording
from stac_mjx_tpu_torch.stac import Stac

FIT = dict(THROUGHPUT, n_frames_per_clip=32)


def _moved_offsets() -> list[str]:
    base = compose_config(REPO / "configs", overrides=["model=firstparty"]).model.KEYPOINT_INITIAL_OFFSETS
    rng = np.random.default_rng(11)
    return [f"model.KEYPOINT_INITIAL_OFFSETS.{k}=[{', '.join(repr(float(x)) for x in np.add(v, rng.uniform(-3e-3, 3e-3, 3)))}]"
            for k, v in base.items()]


def test_built_model_fit_matches_jax_f64():
    overrides = ["model=firstparty", "stac=firstparty", "model.N_ITERS=2"] + _moved_offsets()
    overrides += [f"stac.{k}={str(v).lower()}" for k, v in FIT.items()]
    cfg = compose_config(REPO / "configs", overrides=overrides)
    jcfg = jax_compose_config(REPO / "configs", overrides=overrides)
    b = bridge.bundle_for_config(cfg, REPO)  # built: no checked-in bundle serves these offsets
    assert not np.array_equal(b["site_pos"], bridge.load_bundle()["site_pos"])
    kp, _, _, _ = make_recording(b, n_frames=40, seed=3, device="cpu")
    kp64 = kp.numpy().astype(np.float64)

    js = JaxStac(REPO / jcfg.model.MJCF_PATH, jcfg, list(jcfg.model.KEYPOINT_MODEL_PAIRS.keys()))
    core, scfg = js.stac_core_obj, js._static_cfg
    with x64_mode():
        _, p64 = extract_model(js._mj_model, dtype=jnp.float64)
        lb, ub, isr = (jnp.asarray(b[k]) for k in ("lb", "ub", "is_regularized"))
        jout = jax.device_get(
            jax.jit(lambda p, k: jpipe.fit_offsets_program(core, scfg, p, k, lb, ub, isr, return_full=True))(
                p64, jnp.asarray(kp64))
        )

    ts = Stac(b, cfg.stac.to_dict(), model_config=cfg.model.to_dict(), device="cpu", dtype=torch.float64)
    fit = ts.fit_offsets(torch.as_tensor(kp64))
    # The bounds of test_fit_matches_jax_f64: offsets and markers are well
    # conditioned (float64 rounding only); qpos to 1e-5 for a near-null
    # ball-joint twist, the median frame to 1e-8.
    np.testing.assert_allclose(fit.offsets, jout["offsets"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(fit.marker_sites, jout["marker_sites"], rtol=0, atol=1e-8)
    np.testing.assert_allclose(fit.qpos, jout["qpos"], rtol=0, atol=1e-5)
    assert np.median(np.abs(fit.qpos - jout["qpos"]).max(-1)) < 1e-8
