"""Clip batching of long recordings (port of ``stac_mjx_tpu/utils/batching.py::batch_kp_data``)."""

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
