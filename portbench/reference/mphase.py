"""The closed-form offset solve (STAC's m-phase), plainly.

For poses fixed, the offsets m (K, 3) minimise
    sum_t |y_t - (p_t + R_t m)|^2 + c |D (m - m0)|^2
per keypoint, where p_t, R_t are the frame of the keypoint's body at frame
t, y_t the keypoint, D the regularised keypoints and c the coefficient.
R_t is a rotation, so the normal equations are diagonal:
    m = (sum_t R_t^T (y_t - p_t) + c D m0) / (T + c D).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.fk import FK, qmat


def closed_form_offsets(fk: FK, qpos, keypoints, m0, regularized, coef: float) -> np.ndarray:
    """(K, 3) float64 offsets for poses qpos (T, nq) and keypoints (T, 3K)."""
    dev = fk.device
    q = torch.as_tensor(np.asarray(qpos), device=dev).to(torch.float64)
    y = torch.as_tensor(np.asarray(keypoints), device=dev).to(torch.float64).reshape(q.shape[0], -1, 3)
    fr = fk.frames(q)
    body = torch.as_tensor(fk.m.keypoint_bodies(), device=dev)
    p, R = fr["xpos"][:, body], qmat(fr["xquat"][:, body])
    g = torch.einsum("tkji,tkj->ki", R, y - p)
    anchor = coef * torch.as_tensor(np.asarray(regularized, np.float64), device=dev)[:, None]
    m0 = torch.as_tensor(np.asarray(m0), device=dev, dtype=torch.float64)
    return ((g + anchor * m0) / (q.shape[0] + anchor)).cpu().numpy()
