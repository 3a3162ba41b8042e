"""Clip batching of long recordings and the overlap crossfade (port of
``stac_mjx_tpu/utils/batching.py``). The crossfade is host-side numpy, as in
the JAX package."""

from __future__ import annotations

import numpy as np
import torch

CONTINUOUS_BATCH_OVERLAP = 10


def batch_kp_data(kp_data, n_frames_per_clip: int, continuous: bool = False):
    """Reshape (F, K*3) keypoints, numpy or torch, into (n_clips, clip_frames, K*3).

    Non-continuous mode drops the remainder. Continuous mode makes windows of
    n_frames_per_clip + overlap frames; the last window is wrap-padded (its
    own first frames repeat after its end, as ``np.pad(mode="wrap")``).
    """
    n_frames = n_frames_per_clip
    total_frames = kp_data.shape[0]
    n_batches = int(total_frames // n_frames)
    if n_batches == 0:
        raise ValueError(
            f"recording has {total_frames} frames but "
            f"stac.n_frames_per_clip={n_frames}: need at least one full "
            f"clip; lower n_frames_per_clip or provide more frames"
        )
    if not continuous:
        clipped = kp_data[: n_batches * n_frames]
        return clipped.reshape((n_batches, n_frames) + tuple(kp_data.shape[1:]))
    window = n_frames + CONTINUOUS_BATCH_OVERLAP
    if total_frames < window:
        raise ValueError(
            f"continuous mode needs at least n_frames_per_clip + "
            f"{CONTINUOUS_BATCH_OVERLAP} = {window} frames for the "
            f"overlap window, got {total_frames}; lower "
            f"stac.n_frames_per_clip or set stac.continuous=false"
        )
    starts = range(0, n_batches * n_frames, n_frames)
    batches = [kp_data[s : s + window] for s in starts]
    last = batches[-1]
    batches[-1] = last[np.arange(len(last) + CONTINUOUS_BATCH_OVERLAP) % len(last)]
    if isinstance(kp_data, torch.Tensor):
        return torch.stack(batches, dim=0)
    return np.stack(batches, axis=0)


def crossfade_sigmoid(a, b, *, axis=0, center=0.5, steepness=10.0):
    """Numerically-stable sigmoid blend from a to b along an axis."""
    n = a.shape[axis]
    x = np.linspace(0.0, 1.0, n)
    z = steepness * (x - center)
    m = 0.5 * (1.0 + np.tanh(z / 2.0))
    shape = [1] * a.ndim
    shape[axis] = n
    m = m.reshape(shape)
    return (1.0 - m) * a + m * b


def handle_edge_effects(ik_only_data, n_frames_per_clip: int):
    """Crossfade the overlapping clip boundaries of a continuous ik and stitch
    the windows back into one recording; in place on a StacData, returned.

    The quirks of the JAX package are kept: quaternion columns are blended
    linearly like every other column; the stitch is the first window, the
    middle windows without their head and the last window without head and
    tail, so the result has n_clips * n_frames_per_clip frames (with two
    clips or more, each at least as long as the overlap); a lean payload's
    empty xpos/xquat/marker_sites pass through untouched.
    """

    def f(data: np.ndarray) -> np.ndarray:
        data = np.array(data)
        if data.size == 0:
            return data
        batched = data.reshape((-1, n_frames_per_clip + CONTINUOUS_BATCH_OVERLAP) + data.shape[1:])
        for i in range(batched.shape[0] - 1):
            a = batched[i, -CONTINUOUS_BATCH_OVERLAP:]
            b = batched[i + 1, :CONTINUOUS_BATCH_OVERLAP]
            batched[i, -CONTINUOUS_BATCH_OVERLAP:] = crossfade_sigmoid(a, b, axis=0)
        first = batched[0]
        middle = batched[1:-1, CONTINUOUS_BATCH_OVERLAP:]
        last = batched[-1, CONTINUOUS_BATCH_OVERLAP:-CONTINUOUS_BATCH_OVERLAP]
        return np.concatenate([first, middle.reshape((-1,) + middle.shape[2:]), last], axis=0)

    ik_only_data.qpos = f(ik_only_data.qpos)
    ik_only_data.kp_data = f(ik_only_data.kp_data)
    ik_only_data.xpos = f(ik_only_data.xpos)
    ik_only_data.xquat = f(ik_only_data.xquat)
    ik_only_data.marker_sites = f(ik_only_data.marker_sites)
    return ik_only_data
