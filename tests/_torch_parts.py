"""Shared set-up of the port's lockstep part-pass tests against the JAX
package (``test_torch_parts*.py``), in float64 on the CPU: the throughput
configuration (lockstep gn-lm, jump FK) with the part passes on, fit on 16
frames with N_ITERS=1, ik on 2 clips x 8."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from conftest import x64_mode
from _torch_common import THROUGHPUT, assert_same_static_cfg, bridge, jax_stac, np64, torch_stac
from stac_mjx_tpu import pipeline as jpipe
from stac_mjx_tpu.models import firstparty as jfirstparty
from stac_mjx_tpu.models.builder import extract_model
from stac_mjx_tpu_torch import pipeline as tpipe

MODEL = {"N_ITERS": 1}
N_FIT, C, FC = 16, 2, 8
SCHEDULES = {
    "batched": ({}, None),
    "chain": ({"part_opt_mode": "sequential"}, None),
    "over-cap": ({}, 6 * N_FIT - 1),  # batched asked for, 6 parts x 16 frames over the cap
}


def recording():
    """(keypoints in float64, bundle, float64 JAX parameters)."""
    js = jax_stac(dict(THROUGHPUT, skip_part_opt=False))
    kp, _, _, _ = jfirstparty.make_recording(js.cfg, n_frames=N_FIT + C * FC, seed=3, base_path=".")
    b = bridge.load_bundle()
    with x64_mode():
        _, p64 = extract_model(js._mj_model, dtype=jnp.float64)
    return np.asarray(kp, np.float32).astype(np.float64), b, p64


def stacs(schedule, monkeypatch):
    """Both packages' Stac for the schedule (the cap lowered in both for over-cap)."""
    extra, cap = SCHEDULES[schedule]
    if cap is not None:
        monkeypatch.setattr(jpipe, "_PART_BATCH_MAX_ITEMS", cap)
        monkeypatch.setattr(tpipe, "_PART_BATCH_MAX_ITEMS", cap)
    cfg = dict(THROUGHPUT, skip_part_opt=False, n_frames_per_clip=FC, **extra)
    js, ts = jax_stac(cfg, MODEL), torch_stac(cfg, MODEL, torch.float64)
    assert_same_static_cfg(ts._static_cfg, js._static_cfg)
    assert ts._static_cfg.part_opt_mode == ("sequential" if schedule == "chain" else "batched")
    return js, ts


def check_against_jax(setup, schedule, monkeypatch, fit: bool = True, ik: bool = True) -> None:
    """The port's fit and/or ik against the JAX programs'. Measured: qpos
    <= 4e-8, offsets <= 5e-11 m, ik errors <= 3e-12 m (float64 rounding
    through the LM's accept tests); bounds 1e-6 and 1e-9 m."""
    kp, b, p64 = setup
    js, ts = stacs(schedule, monkeypatch)
    core, jcfg = js.stac_core_obj, js._static_cfg
    fit_kp, bk = kp[:N_FIT], kp[N_FIT:].reshape(C, FC, -1)
    offsets = np.asarray(b["site_pos"])[b["site_idxs"]]
    with x64_mode():
        lb, ub, isr = jnp.asarray(b["lb"]), jnp.asarray(b["ub"]), jnp.asarray(b["is_regularized"])
        if fit:
            jfit = jax.device_get(jax.jit(
                lambda p, k: jpipe.fit_offsets_program(core, jcfg, p, k, lb, ub, isr, return_full=False)
            )(p64, jnp.asarray(fit_kp)))
            offsets = jfit["offsets"]
        if ik:
            jq, je = jax.device_get(jax.jit(
                lambda p, k, o: jpipe.ik_only_program(core, jcfg, p, k, o, lb, ub, return_full=False)
            )(p64, jnp.asarray(bk), jnp.asarray(offsets)))
    if fit:
        tfit = tpipe.fit_offsets_program(ts.stac_core_obj, ts._static_cfg, ts.params, torch.as_tensor(fit_kp),
                                         ts._lb, ts._ub, ts._is_regularized, return_full=False)
        for k in ("offsets", "frame_error", "iter_frame_errors"):
            np.testing.assert_allclose(np64(tfit[k]), jfit[k], rtol=0, atol=1e-9, err_msg=k)
        np.testing.assert_allclose(np64(tfit["qpos"]), jfit["qpos"], rtol=0, atol=1e-6)
    if ik:
        tq, te = tpipe.ik_only_program(ts.stac_core_obj, ts._static_cfg, ts.params, torch.as_tensor(bk),
                                       torch.as_tensor(offsets), ts._lb, ts._ub, return_full=False)
        np.testing.assert_allclose(np64(tq), jq, rtol=0, atol=1e-6)
        np.testing.assert_allclose(np64(te), je, rtol=0, atol=1e-9)
