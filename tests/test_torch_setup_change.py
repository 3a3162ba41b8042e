"""A set-up-only change of the model config moves both packages alike.

``chip_smoke.py`` phase 14 (a) runs firstparty's model config with
ROOT_OPTIMIZATION_KEYPOINT TorsoF and one entry dropped from
TRUNK_OPTIMIZATION_KEYPOINTS and INDIVIDUAL_PART_OPTIMIZATION
(``chip_smoke._setup_only_change``) on the main configuration. Here the fit of
that phase (the first 250 frames of the seed-0 recording, N_ITERS 6) runs on
the CPU in float64 in the port (the checked-in bundle, the set-up computed by
its ``Stac``) and in the JAX package (its ``Stac`` on the MJCF, the fit program
jitted, x64), on that config and on the recorded one. Each package's fit
residual and offset error against the ground truth are lower on the changed
config than on the recorded one, and the two packages agree: offsets, mean
residual and offset error to 1e-7 m. (Frame poses are not
compared: over 6 iterations of 250 frames float64 rounding flips a few
frames' accept tests, which moves their qpos but not the offsets.) Run with
``-s`` to see the numbers.
"""

import copy
import importlib.util
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from conftest import x64_mode
from _torch_common import REPO
from stac_mjx_tpu import pipeline as jpipe
from stac_mjx_tpu.config import config_from_dict as jax_config_from_dict
from stac_mjx_tpu.models.builder import extract_model
from stac_mjx_tpu.stac import Stac as JaxStac
from stac_mjx_tpu.stac import _align_joint_dims
from stac_mjx_tpu_torch import bridge
from stac_mjx_tpu_torch.models.firstparty import make_recording
from stac_mjx_tpu_torch.stac import Stac

# Offsets, mean residual and offset error, m: float64 rounding over 250
# frames x 6 iterations, ~2e-8 for the offsets and ~1e-8 for the residual.
ABS = 1e-7


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _resid(markers, kp) -> float:
    return float(np.linalg.norm(np.reshape(markers, (kp.shape[0], -1, 3)) - np.reshape(kp, (kp.shape[0], -1, 3)),
                                axis=-1).mean())


def test_setup_only_change_moves_both_packages_alike():
    cs = _chip_smoke()
    b = bridge.load_bundle()
    recorded = json.loads(str(b["model_config"]))
    kp, _, true_off, _ = make_recording(b, n_frames=cs.N_FIT, seed=0, device="cpu")
    kp64 = kp.numpy().astype(np.float64)
    stac = dict(cs.THROUGHPUT, n_fit_frames=cs.N_FIT, n_frames_per_clip=cs.CLIP)
    got = {}
    for name, model in (("recorded", recorded), ("changed", cs._setup_only_change(recorded))):
        jcfg = jax_config_from_dict(copy.deepcopy({"model": model, "stac": dict(
            stac, fit_offsets_path="fit.h5", ik_only_path="ik.h5", data_path="unused.nwb")}))
        js = JaxStac(REPO / "models" / "firstparty.xml", jcfg, list(model["KEYPOINT_MODEL_PAIRS"]))
        core, scfg = js.stac_core_obj, js._static_cfg
        with x64_mode():
            _, p64 = extract_model(js._mj_model, dtype=jnp.float64)
            lb, ub, _ = _align_joint_dims(js.topo.jnt_type, np.asarray(js._mj_model.jnt_range), js.topo.jnt_names)
            lb, ub, isr = (jnp.asarray(x, jnp.float64) for x in (lb, ub, js._fit_model.is_regularized))
            jout = jax.device_get(jax.jit(
                lambda p, k: jpipe.fit_offsets_program(core, scfg, p, k, lb, ub, isr, return_full=True))(
                    p64, jnp.asarray(kp64)))
        fit = Stac(b, stac, model_config=model, device="cpu", dtype=torch.float64).fit_offsets(torch.as_tensor(kp64))
        np.testing.assert_allclose(fit.offsets, jout["offsets"], rtol=0, atol=ABS)
        for pkg, out in (("jax", jout), ("port", {"marker_sites": fit.marker_sites, "offsets": fit.offsets})):
            got[name, pkg] = (_resid(out["marker_sites"], kp64), float(np.abs(out["offsets"] - true_off).mean()))
            print(f"{name} config, {pkg}: fit residual {got[name, pkg][0] * 1e3:.4f} mm, "
                  f"offset error {got[name, pkg][1] * 1e3:.4f} mm")
        np.testing.assert_allclose(got[name, "port"], got[name, "jax"], rtol=0, atol=ABS)
    for pkg in ("jax", "port"):
        assert got["changed", pkg][0] < got["recorded", pkg][0] and got["changed", pkg][1] < got["recorded", pkg][1]
