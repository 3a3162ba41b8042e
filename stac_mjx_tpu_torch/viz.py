"""Render fitted results with mujoco's renderer on the host (port of ``stac_mjx_tpu/viz.py``).

A render model is the fitting model's spec (``models/builder.build_body_spec``)
plus a world site per keypoint, a "_new" site per keypoint at its fitted
offset and, optionally, a tendon between the two; frames come from
``mj_fwdPosition`` and ``mujoco.Renderer`` and are written as an mp4. The
MJCF is the ``Stac``'s model config's, resolved as ``bridge.bundle_for_config``
resolves it. mujoco, imageio and OpenCV are imported inside the functions,
mujoco after the headless GL default is set (``builder.import_mujoco``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from stac_mjx_tpu_torch import io
from stac_mjx_tpu_torch.models.builder import build_body_spec, import_mujoco, resolve_mjcf


def build_render_model(
    stac, offsets, show_marker_error: bool = False, height: int = 0, width: int = 0, base_path=None
):
    """Compile the render model: (MjModel, the keypoint sites' indices).

    Keypoint sites start at random sub-mm positions (``np.random``), in
    group 2; height/width grow the offscreen framebuffer when the model's
    visual defaults are smaller than the requested render size. The MJCF is
    resolved under ``base_path`` (default: the working directory)."""
    mujoco = import_mujoco()
    cfg_model = stac.model_cfg
    render_spec = build_body_spec(resolve_mjcf(cfg_model, base_path), cfg_model)
    if width > render_spec.visual.global_.offwidth:
        render_spec.visual.global_.offwidth = width
    if height > render_spec.visual.global_.offheight:
        render_spec.visual.global_.offheight = height
    marker_size = float(cfg_model["MARKER_SIZE"])
    pairs = cfg_model["KEYPOINT_MODEL_PAIRS"]

    keypoint_site_names = []
    for name in pairs.keys():
        start = (np.random.rand(3) - 0.5) * 0.001
        rgba = cfg_model["KEYPOINT_COLOR_PAIRS"][name]
        if isinstance(rgba, str):
            rgba = [float(c) for c in rgba.split(" ")]
        site_name = name + "_kp"
        keypoint_site_names.append(site_name)
        render_spec.worldbody.add_site(name=site_name, size=[marker_size] * 3, rgba=rgba, pos=start, group=2)

    offsets = np.asarray(offsets).reshape((-1, 3))
    for (key, body), pos in zip(pairs.items(), offsets):
        render_spec.body(body).add_site(name=key + "_new", size=[marker_size] * 3, rgba=[0, 0, 0, 1], pos=pos, group=2)

    if show_marker_error:
        for key, body in pairs.items():
            tendon = render_spec.add_tendon(name=key + "-" + body, width=0.001, rgba=[1.0, 0.0, 0.0, 1.0], limited=0)
            tendon.wrap_site(key + "_kp")
            tendon.wrap_site(key + "_new")

    render_mj_model = render_spec.compile()
    keypoint_site_idxs = [
        mujoco.mj_name2id(render_mj_model, mujoco.mjtObj.mjOBJ_SITE, name) for name in keypoint_site_names
    ]
    return render_mj_model, keypoint_site_idxs


def render_stac(
    stac,
    qposes,
    kp_data,
    offsets,
    n_frames: int,
    save_path,
    start_frame: int = 0,
    camera=0,
    height: int = 1200,
    width: int = 1920,
    show_marker_error: bool = False,
    base_path=None,
):
    """Render frames start_frame .. start_frame + n_frames of fitted qposes
    (F, nq) beside their keypoints (F, 3K) and write them to save_path as a
    video at the model's RENDER_FPS; returns the frames."""
    mujoco = import_mujoco()
    qposes = np.asarray(qposes)
    kp_data = np.asarray(kp_data)

    if qposes.shape[0] != kp_data.shape[0]:
        raise ValueError(
            f"Length of qposes ({qposes.shape[0]}) is not equal to the length of kp_data({kp_data.shape[0]})"
        )
    if start_frame < 0 or start_frame > kp_data.shape[0]:
        raise ValueError(
            f"start_frame ({start_frame}) must be non-negative and less than the length of kp_data "
            f"({kp_data.shape[0]})"
        )
    if start_frame + n_frames > kp_data.shape[0]:
        raise ValueError(
            f"start_frame + n_frames ({start_frame} + {n_frames}) must be less than the length of given "
            f"qposes and kp_data ({kp_data.shape[0]})"
        )

    render_mj_model, keypoint_site_idxs = build_render_model(
        stac, offsets, show_marker_error, height=height, width=width, base_path=base_path
    )

    scene_option = mujoco.MjvOption()
    scene_option.geomgroup[1] = 0
    scene_option.geomgroup[2] = 1
    scene_option.sitegroup[2] = 1
    scene_option.sitegroup[3] = 0
    scene_option.flags[mujoco.mjtVisFlag.mjVIS_TRANSPARENT] = True
    scene_option.flags[mujoco.mjtVisFlag.mjVIS_LIGHT] = True
    scene_option.flags[mujoco.mjtVisFlag.mjVIS_CONVEXHULL] = True
    scene_option.flags[mujoco.mjtRndFlag.mjRND_SHADOW] = True
    scene_option.flags[mujoco.mjtRndFlag.mjRND_REFLECTION] = True
    scene_option.flags[mujoco.mjtRndFlag.mjRND_SKYBOX] = True
    scene_option.flags[mujoco.mjtRndFlag.mjRND_FOG] = True

    mj_data = mujoco.MjData(render_mj_model)
    mujoco.mj_kinematics(render_mj_model, mj_data)
    renderer = mujoco.Renderer(render_mj_model, height=height, width=width)

    kp_data = kp_data[: qposes.shape[0]][start_frame : start_frame + n_frames]
    qposes = qposes[start_frame : start_frame + n_frames]

    frames = []
    for qpos, kps in zip(qposes, kp_data):
        render_mj_model.site_pos[keypoint_site_idxs] = np.reshape(kps, (-1, 3))
        mj_data.qpos = qpos
        mujoco.mj_fwdPosition(render_mj_model, mj_data)
        renderer.update_scene(mj_data, camera=camera, scene_option=scene_option)
        frames.append(renderer.render())
    _write_video(save_path, frames, int(stac.model_cfg.get("RENDER_FPS", 50)))
    return frames


def _write_video(save_path, frames, fps: int) -> None:
    """Stream frames to disk: imageio/ffmpeg when available, else OpenCV."""
    import imageio

    try:
        with imageio.get_writer(save_path, fps=fps) as video:
            for f in frames:
                video.append_data(f)
    except (ValueError, ImportError):
        import cv2

        h, w = frames[0].shape[:2]
        out = cv2.VideoWriter(str(save_path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        try:
            for f in frames:
                out.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        finally:
            out.release()


def viz_stac(
    data_path,
    n_frames: int,
    save_path,
    start_frame: int = 0,
    camera=0,
    height: int = 1200,
    width: int = 1920,
    base_path: Path | None = None,
    show_marker_error: bool = False,
):
    """Render the fitted qpos of a STAC output file (its config, model and
    keypoints): returns (config, frames). The ``Stac`` is built on the CPU:
    rendering runs on the host and needs no solve."""
    from stac_mjx_tpu_torch.main import make_stac

    cfg, d = io.load_stac_data(data_path)
    base_path = Path(base_path) if base_path is not None else Path.cwd()
    stac = make_stac(cfg, d.kp_names, device="cpu", base_path=base_path)
    return cfg, render_stac(
        stac, d.qpos, d.kp_data, d.offsets, n_frames, save_path, start_frame, camera, height, width,
        show_marker_error, base_path=base_path,
    )
