"""A compiled model's raw arrays, as the reference reads them.

The bundle is an ``.npz`` of plain arrays (the model's kinematic tree and
joint table, written by the model exporter). Both the program under test and
this reference read the same file; nothing here depends on what the
program derives from it.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

# mujoco.mjtJoint order.
FREE, BALL, SLIDE, HINGE = 0, 1, 2, 3
QPOS_WIDTH = {FREE: 7, BALL: 4, SLIDE: 1, HINGE: 1}


class Model:
    """The kinematic tree of a bundle: bodies in index order (a parent
    precedes its children), their joints, and the keypoint sites."""

    def __init__(self, path: str | Path):
        with np.load(path, allow_pickle=False) as z:
            self.arrays = {k: z[k] for k in z.files}
        a = self.arrays
        self.path = Path(path)
        self.nq = int(a["nq"])
        self.nbody = int(a["nbody"])
        self.parent = a["body_parentid"].astype(np.int64)
        self.jnt_type = a["jnt_type"].astype(np.int64)
        self.jnt_qposadr = a["jnt_qposadr"].astype(np.int64)
        self.jnt_bodyid = a["jnt_bodyid"].astype(np.int64)
        self.jnt_range = a["jnt_range"].astype(np.float64)
        self.site_bodyid = a["site_bodyid"].astype(np.int64)
        self.site_idxs = a["site_idxs"].astype(np.int64)  # keypoint k -> site
        self.body_pos = a["body_pos"].astype(np.float64)
        self.body_quat = a["body_quat"].astype(np.float64)
        self.jnt_axis = a["jnt_axis"].astype(np.float64)
        self.jnt_pos = a["jnt_pos"].astype(np.float64)
        self.qpos0 = a["qpos0"].astype(np.float64)
        self.site_pos = a["site_pos"].astype(np.float64)
        self.kp_names = [str(s) for s in a["kp_names"]]
        self.model_config = json.loads(str(a["model_config"]))
        if any(self.parent[b] >= b for b in range(1, self.nbody)):
            raise ValueError("bodies are not in tree order")
        # joints of each body, in order
        self.body_joints = [[] for _ in range(self.nbody)]
        for j, b in enumerate(self.jnt_bodyid):
            self.body_joints[int(b)].append(j)

    @property
    def n_keypoints(self) -> int:
        return len(self.site_idxs)

    def initial_offsets(self) -> np.ndarray:
        """(K, 3) the keypoint sites' positions in their bodies' frames."""
        return self.site_pos[self.site_idxs].copy()

    def keypoint_bodies(self) -> np.ndarray:
        """(K,) the body each keypoint's site hangs on."""
        return self.site_bodyid[self.site_idxs]

    def regularized(self) -> np.ndarray:
        """(K,) bool: keypoints in the model config's SITES_TO_REGULARIZE."""
        reg = set(self.model_config.get("SITES_TO_REGULARIZE") or [])
        return np.array([k in reg for k in self.kp_names])

    def quaternion_mask(self) -> np.ndarray:
        """(nq,) bool: the coordinates of free and ball joints' quaternions."""
        mask = np.zeros(self.nq, bool)
        for j, t in enumerate(self.jnt_type):
            qa = int(self.jnt_qposadr[j])
            if t == FREE:
                mask[qa + 3 : qa + 7] = True
            elif t == BALL:
                mask[qa : qa + 4] = True
        return mask

    def box(self) -> tuple[np.ndarray, np.ndarray]:
        """(lb, ub) per qpos coordinate, as the configuration states them:
        a joint's range where it has one; a free joint's translation
        unbounded and its quaternion in [-1, 1]; a ball's quaternion in
        [-1, 1]; an unlimited hinge in [-2 pi, 2 pi], an unlimited slide
        unbounded. The lower bound is then clamped to <= 0 (the STAC
        convention, which keeps the rest pose inside the box)."""
        lb = np.empty(self.nq)
        ub = np.empty(self.nq)
        for j, t in enumerate(self.jnt_type):
            qa, w = int(self.jnt_qposadr[j]), QPOS_WIDTH[int(t)]
            lo, hi = self.jnt_range[j]
            limited = not (lo == 0 and hi == 0)
            if t == FREE:
                lb[qa : qa + 3], ub[qa : qa + 3] = -np.inf, np.inf
                lb[qa + 3 : qa + 7], ub[qa + 3 : qa + 7] = -1.0, 1.0
            elif limited:
                lb[qa : qa + w], ub[qa : qa + w] = lo, hi
            elif t == BALL:
                lb[qa : qa + 4], ub[qa : qa + 4] = -1.0, 1.0
            elif t == HINGE:
                lb[qa], ub[qa] = -2 * np.pi, 2 * np.pi
            else:
                lb[qa], ub[qa] = -np.inf, np.inf
        return np.minimum(lb, 0.0), ub
