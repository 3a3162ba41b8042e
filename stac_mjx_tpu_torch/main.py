"""Top-level pipeline driver: calibration fit, full-recording ik, artifacts
(port of ``stac_mjx_tpu/main.py``).

The same validation rules, skip flags and h5 artifacts, and the same
phase-granular resume contract: the fit h5 is the checkpoint, and the ik
always reads its offsets back from that file, never from memory. The ik also
takes ``continuous`` and the config it writes from the fit h5's config, while
the clip length comes from the caller's. The fitting model is the checked-in
bundle that matches ``cfg.model`` (``bridge.bundle_for_config``), since the
port compiles no MJCF. The JAX driver's XLA flags (its persistent compile
cache) have no counterpart here.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path

import numpy as np
import torch

from stac_mjx_tpu_torch import bridge, io
from stac_mjx_tpu_torch.config import compose_config
from stac_mjx_tpu_torch.stac import Stac
from stac_mjx_tpu_torch.utils.batching import handle_edge_effects
from stac_mjx_tpu_torch.utils.velocity import compute_velocity_from_kinematics

log = logging.getLogger(__name__)


def load_configs(config_dir: Path | str, config_name: str = "config"):
    """Compose and schema-validate the config tree rooted at ``config_dir``."""
    cfg = compose_config(config_dir, config_name=config_name)
    log.info("Composed config '%s' from %s", config_name, config_dir)
    return cfg


def _require_kp_columns(kp_data, kp_names) -> None:
    """kp_data must be (n_frames, 3 * len(kp_names)); raise otherwise."""
    want = 3 * len(kp_names)
    got = kp_data.shape[1]
    if got != want:
        raise ValueError(
            f"keypoint array is (n_frames, {got}) but {len(kp_names)} names "
            f"imply {want} columns; reshape to (n_frames, n_keypoints*3) or "
            f"fix the keypoint-name list"
        )


def make_stac(cfg, kp_names, device="cuda", dtype=torch.float32) -> Stac:
    """The ``Stac`` of a composed config: its model's bundle, the config's
    MODEL_SCALARS as overrides, and its stac keys. The keypoint names must be
    the bundle's, in its order (``load_data`` returns them so)."""
    bundle = bridge.bundle_for_config(cfg)
    names = [str(s) for s in bundle["kp_names"]]
    if list(kp_names) != names:
        raise ValueError(
            f"keypoint names {list(kp_names)} differ from the model bundle's {names}; "
            f"pass the names load_data returns (KEYPOINT_MODEL_PAIRS order)"
        )
    model = {k: cfg.model[k] for k in bridge.MODEL_SCALARS if k in cfg.model}
    return Stac(bundle, cfg.stac.to_dict(), model=model, device=device, dtype=dtype)


def fit_phase(stac: Stac, cfg, kp_data, out_path: Path) -> Path:
    """Run the alternating calibration on the first n_fit_frames and save it."""
    fit_slice = kp_data[: int(cfg.stac.n_fit_frames)]
    log.info("fit_offsets on %s frames", fit_slice.shape[0])
    result = stac.fit_offsets(fit_slice)
    io.save_data_to_h5(config=cfg, file_path=out_path, **result.as_dict())
    log.info("fit artifact written: %s", out_path)
    return out_path


def infer_qvels(stac: Stac, qpos: np.ndarray, clip_len: int) -> np.ndarray:
    """qvel (F, ·) of an ik's qpos (F, nq), per clip of clip_len frames, on
    the Stac's device in qpos' dtype."""
    q = torch.as_tensor(np.asarray(qpos), device=stac.device)
    qvel = compute_velocity_from_kinematics(
        q.reshape(-1, clip_len, q.shape[-1]), dt=stac.timestep, freejoint=stac._freejoint
    )
    return qvel.reshape(-1, qvel.shape[-1]).cpu().numpy()


def ik_phase(stac: Stac, cfg, kp_data, fit_path: Path, out_path: Path) -> Path:
    """Full-recording ik with offsets restored from the fit artifact."""
    clip_len = int(cfg.stac.n_frames_per_clip)
    n_frames = kp_data.shape[0]
    if n_frames % clip_len != 0:
        raise ValueError(
            f"cannot split {n_frames} frames into clips of {clip_len}: "
            f"choose stac.n_frames_per_clip to divide the recording length"
        )

    # Resume contract: offsets come from the fit h5, never from memory, so
    # a run with skip_fit_offsets=true picks up a previous fit's artifact.
    cfg, fit_data = io.load_stac_data(fit_path)
    result = stac.ik_only(kp_data, fit_data.offsets)

    if cfg.stac.continuous:
        log.info("crossfading clip overlaps (continuous recording)")
        result = handle_edge_effects(result, clip_len)

    if cfg.stac.infer_qvels:
        t0 = time.time()
        result.qvel = infer_qvels(stac, result.qpos, clip_len)
        log.info("qvel inference took %.2fs", time.time() - t0)

    io.save_data_to_h5(config=cfg, file_path=out_path, **result.as_dict())
    log.info("ik artifact written: %s", out_path)
    return out_path


def run_stac(cfg, kp_data, kp_names, base_path: Path | None = None, device="cuda", dtype=torch.float32):
    """Run fit_offsets then ik_only per the config's skip flags.

    Runs on the card unless ``device`` says otherwise, and raises when there
    is none (``bridge.resolve_device``). ``dtype`` is the compute dtype (the
    tests hold the driver in float64 on the CPU). Returns
    ``(fit_h5_path, ik_h5_path or None)``.
    """
    base_path = Path(base_path) if base_path is not None else Path.cwd()
    _require_kp_columns(kp_data, kp_names)
    device = bridge.resolve_device(device)
    t_start = time.time()

    fit_path = base_path / cfg.stac.fit_offsets_path
    ik_path = base_path / cfg.stac.ik_only_path
    stac = make_stac(cfg, kp_names, device=device, dtype=dtype)

    if cfg.stac.skip_fit_offsets:
        log.info(
            "fit_offsets skipped (stac.skip_fit_offsets=true); expecting an existing fit artifact at %s",
            fit_path,
        )
    else:
        fit_phase(stac, cfg, kp_data, fit_path)

    if cfg.stac.skip_ik_only:
        log.info("ik_only skipped (stac.skip_ik_only=true)")
        log.info("pipeline finished in %.2f min", (time.time() - t_start) / 60)
        return fit_path, None

    ik_phase(stac, cfg, kp_data, fit_path, ik_path)
    log.info("pipeline finished in %.2f min", (time.time() - t_start) / 60)
    return fit_path, ik_path
