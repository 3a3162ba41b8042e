"""The model half of the ``Stac``'s set-up, from a model config, in plain numpy
(port of ``stac_mjx_tpu/stac.py`` ``_align_joint_dims``, the root keypoint,
``part_opt_setup`` and the trunk mask, and of ``stac_mjx_tpu/models/builder.py``'s
regularisation mask).

None of it needs mujoco: it reads the model config and the compiled model's
joint table (``jnt_type``, ``jnt_range``, ``jnt_names``), which a bundle
carries. So the port's ``Stac`` computes it on the card's host for any
change of the keys that shape no compiled array (ROOT_OPTIMIZATION_KEYPOINT,
TRUNK_OPTIMIZATION_KEYPOINTS, INDIVIDUAL_PART_OPTIMIZATION,
SITES_TO_REGULARIZE).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from stac_mjx_tpu_torch.models.kinematics import JNT_BALL, JNT_FREE, JNT_HINGE, JNT_SLIDE

_JOINT_DIMS = {JNT_FREE: 7, JNT_BALL: 4, JNT_SLIDE: 1, JNT_HINGE: 1}


def align_joint_dims(types, ranges, names) -> tuple[np.ndarray, np.ndarray, list[str]]:
    """Box bounds (lb, ub) per qpos coordinate and each coordinate's joint name.

    The JAX package's quirks, kept: a free joint gets +-inf on its
    translation and [-1, 1] on its quaternion (clipped, never renormalised);
    a (0, 0) range means unconstrained (ball +-1, slide +-inf, hinge
    +-2 pi); the lower bound is clamped to <= 0 elementwise at the end."""
    lb, ub, part_names = [], [], []
    unconstrained = {
        JNT_FREE: (np.concatenate([-np.inf * np.ones(3), -np.ones(4)]),
                   np.concatenate([np.inf * np.ones(3), np.ones(4)])),
        JNT_BALL: (-np.ones(4), np.ones(4)),
        JNT_SLIDE: (-np.inf * np.ones(1), np.inf * np.ones(1)),
        JNT_HINGE: (-2 * np.pi * np.ones(1), 2 * np.pi * np.ones(1)),
    }
    for jtype, jrange, name in zip(types, ranges, names):
        jtype = int(jtype)
        dims = _JOINT_DIMS[jtype]
        if jtype == JNT_FREE:
            lo, hi = unconstrained[jtype]
        else:
            lo, hi = jrange
            if lo == 0 and hi == 0:
                lo, hi = unconstrained[jtype]
            else:
                lo, hi = lo * np.ones(dims), hi * np.ones(dims)
        lb.append(lo)
        ub.append(hi)
        part_names += [name] * dims
    return np.minimum(np.concatenate(lb), 0.0), np.concatenate(ub), part_names


def keypoint_names(model_cfg: Mapping) -> list[str]:
    """The keypoints in model order: KEYPOINT_MODEL_PAIRS' key order."""
    return list(model_cfg["KEYPOINT_MODEL_PAIRS"].keys())


def root_keypoint_index(model_cfg: Mapping, kp_names: list[str]) -> int:
    """ROOT_OPTIMIZATION_KEYPOINT's index in kp_names, or -1 without the key."""
    if "ROOT_OPTIMIZATION_KEYPOINT" in model_cfg:
        return kp_names.index(model_cfg["ROOT_OPTIMIZATION_KEYPOINT"])
    return -1


def part_masks(model_cfg: Mapping, part_names: list[str]) -> list[np.ndarray]:
    """One qpos mask per INDIVIDUAL_PART_OPTIMIZATION entry: the coordinates
    whose joint name contains any of the entry's substrings."""
    parts_map = model_cfg.get("INDIVIDUAL_PART_OPTIMIZATION")
    if parts_map is None:
        return []
    return [np.array([any(part in name for part in parts) for name in part_names])
            for parts in dict(parts_map.items()).values()]


def trunk_mask(model_cfg: Mapping, kp_names: list[str]) -> np.ndarray:
    """(K,) bool: the keypoints in TRUNK_OPTIMIZATION_KEYPOINTS."""
    trunk = model_cfg["TRUNK_OPTIMIZATION_KEYPOINTS"]
    return np.array([n in trunk for n in kp_names], dtype=bool)


def regularized_mask(model_cfg: Mapping, kp_names: list[str]) -> np.ndarray:
    """(K, 3) float64 0/1: the keypoints in SITES_TO_REGULARIZE."""
    reg = set(model_cfg.get("SITES_TO_REGULARIZE") or [])
    return np.array([[1.0, 1.0, 1.0] if k in reg else [0.0, 0.0, 0.0] for k in kp_names], dtype=np.float64)


def model_setup(model_cfg: Mapping, arrays: Mapping) -> dict:
    """Every array the ``Stac`` derives from its model config, under the
    bundle's key names: kp_names, lb, ub, part_names, indiv_parts (P, nq),
    trunk_kps, root_kp_idx, is_regularized. ``arrays`` holds the compiled
    model's ``jnt_type``, ``jnt_range`` and ``jnt_names`` (a bundle does)."""
    kp_names = keypoint_names(model_cfg)
    names = [str(s) for s in arrays["jnt_names"]]
    lb, ub, part_names = align_joint_dims(arrays["jnt_type"], np.asarray(arrays["jnt_range"]), names)
    return {
        "kp_names": kp_names,
        "lb": lb,
        "ub": ub,
        "part_names": part_names,
        "indiv_parts": np.array(part_masks(model_cfg, part_names), dtype=bool).reshape(-1, len(part_names)),
        "trunk_kps": trunk_mask(model_cfg, kp_names),
        "root_kp_idx": root_keypoint_index(model_cfg, kp_names),
        "is_regularized": regularized_mask(model_cfg, kp_names),
    }
