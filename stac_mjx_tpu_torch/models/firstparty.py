"""The first-party critter: its keypoint tables, MJCF and configs, and
synthetic recordings of it (port of ``stac_mjx_tpu/models/firstparty.py``).

The tables, ``firstparty_xml``, ``firstparty_model_yaml`` and
``firstparty_stac_yaml`` are a copy of the JAX module's (the port imports
nothing of it), and their strings come out identical, so ``write_assets``
regenerates the checked-in ``models/firstparty.xml`` and
``configs/{model,stac}/firstparty.yaml`` byte for byte (``python -m
stac_mjx_tpu_torch.models.firstparty <repo root>``; tests hold both copies
equal). ``make_recording`` runs the same numpy RNG sequence over the
bundle's joint table and ranges as the JAX version, and computes the
keypoints with the port's FK, so a machine without jax or mujoco makes the
same recording with its ground-truth offsets; ``write_recording_nwb`` saves
one as an .nwb file.
"""

from __future__ import annotations

from pathlib import Path
from typing import Mapping

import numpy as np
import torch

from stac_mjx_tpu_torch.bridge import bundle_for_config, fit_model_from_arrays, resolve_device
from stac_mjx_tpu_torch.models.kinematics import (
    JNT_BALL,
    JNT_FREE,
    JNT_HINGE,
    JNT_SLIDE,
    make_fk_jump,
)

# keypoint -> (body, initial offset in the body frame, regularized?)
KEYPOINTS = {
    "Snout": ("head", (0.035, 0.0, 0.0), False),
    "HeadTop": ("head", (0.01, 0.0, 0.02), False),
    "Jaw": ("jaw", (0.015, 0.0, -0.005), True),
    "Neck": ("neck", (0.0, 0.0, 0.02), False),
    "TorsoF": ("torso", (0.05, 0.0, 0.03), False),
    "TorsoM": ("torso", (0.0, 0.0, 0.035), False),
    "PelvisTop": ("pelvis", (0.0, 0.0, 0.03), False),
    "HipL": ("pelvis", (-0.01, 0.03, 0.0), False),
    "HipR": ("pelvis", (-0.01, -0.03, 0.0), False),
    "TailBase": ("tail_base", (0.0, 0.0, 0.01), False),
    "TailTip": ("tail_tip", (-0.05, 0.0, 0.0), True),
    "ShoulderL": ("leg_FL_upper", (0.0, 0.015, 0.0), False),
    "ElbowL": ("leg_FL_lower", (0.005, 0.01, 0.0), False),
    "PawFL": ("leg_FL_foot", (0.01, 0.0, -0.01), True),
    "ShoulderR": ("leg_FR_upper", (0.0, -0.015, 0.0), False),
    "ElbowR": ("leg_FR_lower", (0.005, -0.01, 0.0), False),
    "PawFR": ("leg_FR_foot", (0.01, 0.0, -0.01), True),
    "ThighL": ("leg_HL_upper", (0.0, 0.015, 0.0), False),
    "KneeL": ("leg_HL_lower", (0.005, 0.01, 0.0), False),
    "PawHL": ("leg_HL_foot", (0.01, 0.0, -0.01), True),
    "ThighR": ("leg_HR_upper", (0.0, -0.015, 0.0), False),
    "KneeR": ("leg_HR_lower", (0.005, -0.01, 0.0), False),
    "PawHR": ("leg_HR_foot", (0.01, 0.0, -0.01), True),
}

TRUNK_KEYPOINTS = ["TorsoF", "TorsoM", "PelvisTop", "HipL", "HipR"]
ROOT_KEYPOINT = "TorsoM"
PART_GROUPS = {
    "head": ["neck_", "head_", "jaw_"],
    "leg_FL": ["leg_FL"],
    "leg_FR": ["leg_FR"],
    "leg_HL": ["leg_HL"],
    "leg_HR": ["leg_HR"],
    "tail": ["tail_"],
}


def _leg(prefix: str, attach: str, y: float) -> str:
    """One 3-segment leg: ball shoulder/hip, limited knee, unlimited ankle."""
    return f"""
      <body name="{prefix}_upper" pos="{attach} {y} -0.015">
        <joint name="{prefix}_ball" type="ball"/>
        <geom type="capsule" fromto="0 0 0 0 0 -0.055" size="0.008"/>
        <body name="{prefix}_lower" pos="0 0 -0.055">
          <joint name="{prefix}_knee" type="hinge" axis="0 1 0" range="-2.0 2.0"/>
          <geom type="capsule" fromto="0 0 0 0 0 -0.05" size="0.006"/>
          <body name="{prefix}_foot" pos="0 0 -0.05">
            <joint name="{prefix}_ankle" type="hinge" axis="0 1 0"/>
            <geom type="capsule" fromto="0 0 0 0.02 0 0" size="0.005"/>
          </body>
        </body>
      </body>"""


def firstparty_xml() -> str:
    """The critter MJCF (radians; rodent-scale geometry)."""
    front = _leg("leg_FL", "0.05", 0.04) + _leg("leg_FR", "0.05", -0.04)
    hind = _leg("leg_HL", "-0.02", 0.04) + _leg("leg_HR", "-0.02", -0.04)
    return f"""<mujoco model="firstparty_critter">
  <compiler angle="radian"/>
  <option timestep="0.002"/>
  <worldbody>
    <body name="torso" pos="0 0 0.12">
      <freejoint name="root"/>
      <geom type="capsule" fromto="-0.06 0 0 0.06 0 0" size="0.025"/>
      {front}
      <body name="neck" pos="0.08 0 0.01">
        <joint name="neck_ball" type="ball"/>
        <geom type="capsule" fromto="0 0 0 0.03 0 0.01" size="0.012"/>
        <body name="head" pos="0.035 0 0.012">
          <joint name="head_nod" type="hinge" axis="0 1 0" range="-1.0 1.0"/>
          <geom type="sphere" size="0.018" pos="0.01 0 0"/>
          <body name="jaw" pos="0.015 0 -0.012">
            <joint name="jaw_slide" type="slide" axis="1 0 0" range="-0.006 0.012"/>
            <geom type="capsule" fromto="0 0 0 0.02 0 0" size="0.004"/>
          </body>
        </body>
      </body>
      <body name="pelvis" pos="-0.075 0 0">
        <joint name="spine_bend" type="hinge" axis="0 1 0" range="-0.8 0.8"/>
        <joint name="spine_twist" type="hinge" axis="1 0 0"/>
        <geom type="capsule" fromto="0 0 0 -0.03 0 0" size="0.02"/>
        {hind}
        <body name="tail_base" pos="-0.04 0 0">
          <joint name="tail_base_ball" type="ball"/>
          <geom type="capsule" fromto="0 0 0 -0.04 0 0" size="0.006"/>
          <body name="tail_tip" pos="-0.045 0 0">
            <joint name="tail_tip_bend" type="hinge" axis="0 1 0" range="-1.5 1.5"/>
            <geom type="capsule" fromto="0 0 0 -0.04 0 0" size="0.004"/>
          </body>
        </body>
      </body>
    </body>
  </worldbody>
</mujoco>
"""


def firstparty_model_yaml() -> str:
    """configs/model/firstparty.yaml content from the canonical tables."""
    lines = [
        "# First-party 23-keypoint critter (generated by",
        "# stac_mjx_tpu/models/firstparty.py — edit there and regenerate).",
        "# Self-contained: no reference-checkout assets required.",
        'MJCF_PATH: "models/firstparty.xml"',
        "",
        "FTOL: 1.0e-04",
        "ROOT_FTOL: 1.0e-05",
        "LIMB_FTOL: 1.0e-06",
        "N_ITERS: 6",
        "N_ITER_Q: 400",
        "",
        f"KP_NAMES: [{', '.join(KEYPOINTS)}]",
        "",
        f"ROOT_OPTIMIZATION_KEYPOINT: {ROOT_KEYPOINT}",
        "",
        "KEYPOINT_MODEL_PAIRS:",
    ]
    for kp, (body, _, _) in KEYPOINTS.items():
        lines.append(f"  {kp}: {body}")
    lines += ["", "KEYPOINT_INITIAL_OFFSETS:"]
    for kp, (_, off, _) in KEYPOINTS.items():
        lines.append(f"  {kp}: [{off[0]}, {off[1]}, {off[2]}]")
    lines += [
        "",
        f"TRUNK_OPTIMIZATION_KEYPOINTS: [{', '.join(TRUNK_KEYPOINTS)}]",
        "",
        "INDIVIDUAL_PART_OPTIMIZATION:",
    ]
    for group, substrings in PART_GROUPS.items():
        lines.append(f"  {group}: [{', '.join(substrings)}]")
    reg = [kp for kp, (_, _, r) in KEYPOINTS.items() if r]
    lines += [
        "",
        "SCALE_FACTOR: 0.9",
        "MOCAP_SCALE_FACTOR: 0.001",
        "",
        f"SITES_TO_REGULARIZE: [{', '.join(reg)}]",
        "RENDER_FPS: 50",
        "N_SAMPLE_FRAMES: 50",
        "M_REG_COEF: 1.0",
        "MARKER_SIZE: 0.005",
        "",
    ]
    return "\n".join(lines)


def firstparty_stac_yaml() -> str:
    """configs/stac/firstparty.yaml content."""
    return """# First-party critter workload (self-contained; data synthesized by
# stac_mjx_tpu.models.firstparty.make_recording).
fit_offsets_path: "firstparty_fit.h5"
ik_only_path: "firstparty_ik_only.h5"
data_path: "firstparty_recording.nwb"
continuous: false
n_fit_frames: 50
num_clips: 1
skip_fit_offsets: false
skip_ik_only: false
infer_qvels: false
n_frames_per_clip: 50
mujoco:
  solver: "newton"
  iterations: 1
  ls_iterations: 4
"""


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


def write_recording_nwb(
    nwb_path,
    cfg,
    n_frames: int = 200,
    seed: int = 0,
    noise_m: float = 0.0,
    base_path: str | Path = ".",
    device: torch.device | str = "cuda",
):
    """Synthesize a recording of a composed config's model and save it as an
    ndx-pose-layout .nwb file (the port's ``utils/convert.save_nwb``; h5py
    is imported there).

    The model is ``bridge.bundle_for_config(cfg, base_path)``. The file is in
    the config's mocap units (meters / MOCAP_SCALE_FACTOR, mm with 0.001), so
    ``io.load_data`` reads it back like a real recording. Returns (kp_data
    (n_frames, K*3) meters, kp_names, true_offsets (K, 3), qs) as numpy.
    """
    from stac_mjx_tpu_torch.utils.convert import save_nwb

    kp, names, true_offsets, qs = make_recording(
        bundle_for_config(cfg, base_path), n_frames=n_frames, seed=seed, noise_m=noise_m, device=device
    )
    kp = kp.cpu().numpy()
    scaled = kp.reshape(n_frames, len(names), 3) / float(cfg.model.MOCAP_SCALE_FACTOR)
    save_nwb(nwb_path, np.transpose(scaled, (0, 2, 1)), names)
    return kp, names, true_offsets, qs


def write_assets(repo_root: str | Path = ".") -> None:
    """Regenerate the checked-in XML + config files from the tables above."""
    root = Path(repo_root)
    (root / "models" / "firstparty.xml").write_text(firstparty_xml())
    (root / "configs" / "model" / "firstparty.yaml").write_text(firstparty_model_yaml())
    (root / "configs" / "stac" / "firstparty.yaml").write_text(firstparty_stac_yaml())
    print("wrote models/firstparty.xml, configs/{model,stac}/firstparty.yaml")


if __name__ == "__main__":
    import sys

    write_assets(sys.argv[1] if len(sys.argv) > 1 else ".")
