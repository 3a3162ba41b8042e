"""Synthetic recordings of the first-party critter (port of
``stac_mjx_tpu/models/firstparty.py::make_recording``).

Runs the same numpy RNG sequence over the bundle's joint table and ranges as
the JAX version, and computes the keypoints with the port's FK, so a machine
without jax or mujoco makes the same recording with its ground-truth offsets.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from stac_mjx_tpu_torch.bridge import fit_model_from_arrays, resolve_device
from stac_mjx_tpu_torch.models.kinematics import (
    JNT_BALL,
    JNT_FREE,
    JNT_HINGE,
    JNT_SLIDE,
    make_fk_jump,
)


def make_recording(
    bundle: Mapping[str, np.ndarray],
    n_frames: int = 200,
    seed: int = 0,
    noise_m: float = 0.0,
    device: torch.device | str = "cuda",
    dtype: torch.dtype = torch.float32,
):
    """Mocap by FK of smooth ground-truth motion with perturbed offsets.

    Returns (kp_data (n_frames, K*3) meters as a tensor on ``device``,
    kp_names, true_offsets (K, 3) float64, qs (n_frames, nq) numpy in
    ``dtype``). Hinges/slides follow in-range sinusoids, ball joints
    rotation-vector sinusoids about two axes, the free root a slow wander
    and roll. ``noise_m`` adds iid gaussian keypoint noise in meters. Runs
    on the card unless ``device`` says otherwise; raises if there is none.
    """
    device = resolve_device(device)
    fm = fit_model_from_arrays(bundle, device, dtype)
    params = fm.params
    site_idxs = torch.as_tensor(fm.site_idxs, device=device)
    rng = np.random.default_rng(seed)

    init_offsets = params.site_pos[site_idxs].cpu().numpy()
    true_offsets = init_offsets + rng.uniform(-0.008, 0.008, init_offsets.shape)
    params = params.set_site_pos(torch.as_tensor(true_offsets, device=device), site_idxs)

    t = np.arange(n_frames) / 50.0
    qs = np.tile(params.qpos0.cpu().numpy().astype(np.float64), (n_frames, 1))
    jnt_range = np.asarray(bundle["jnt_range"])
    for j in range(fm.topo.njnt):
        qa = int(fm.topo.jnt_qposadr[j])
        jtype = int(fm.topo.jnt_type[j])
        freq = rng.uniform(0.3, 1.2)
        phase = rng.uniform(0, 2 * np.pi)
        if jtype in (JNT_HINGE, JNT_SLIDE):
            lo, hi = jnt_range[j]
            amp = 0.4 * (hi - lo) if hi > lo else 0.7
            qs[:, qa] += amp * np.sin(2 * np.pi * freq * t + phase)
        elif jtype == JNT_BALL:  # rotation-vector sinusoid about two axes -> quat
            axis = rng.normal(size=3)
            axis /= np.linalg.norm(axis)
            axis2 = rng.normal(size=3)
            axis2 -= axis * (axis2 @ axis)
            axis2 /= np.linalg.norm(axis2)
            ang = 0.45 * np.sin(2 * np.pi * freq * t + phase)
            ang2 = 0.3 * np.sin(2 * np.pi * rng.uniform(0.3, 1.2) * t + rng.uniform(0, 6))
            rv = ang[:, None] * axis + ang2[:, None] * axis2
            an = np.linalg.norm(rv, axis=-1) + 1e-12
            qs[:, qa] = np.cos(an / 2)
            qs[:, qa + 1 : qa + 4] = (np.sin(an / 2) / an)[:, None] * rv
        elif jtype == JNT_FREE:  # slow wander + gentle roll
            for c in range(3):
                qs[:, qa + c] += 0.04 * np.sin(
                    2 * np.pi * rng.uniform(0.1, 0.3) * t + rng.uniform(0, 6)
                )
            ang = 0.2 * np.sin(2 * np.pi * freq * t + phase)
            axis = rng.normal(size=3)
            axis /= np.linalg.norm(axis)
            qs[:, qa + 3] = np.cos(ang / 2)
            qs[:, qa + 4 : qa + 7] = np.sin(ang / 2)[:, None] * axis

    q_dev = torch.as_tensor(qs, device=device).to(dtype)
    fk = make_fk_jump(fm.topo, device)
    site_xpos = fk(params, q_dev).site_xpos[:, site_idxs]
    if noise_m:
        noise = rng.normal(0, noise_m, tuple(site_xpos.shape))
        site_xpos = site_xpos + torch.as_tensor(noise, device=device).to(dtype)
    kp_data = site_xpos.reshape(n_frames, -1)
    kp_names = [str(s) for s in bundle["kp_names"]]
    return kp_data, kp_names, true_offsets, q_dev.cpu().numpy()
