"""Synthetic mocap recordings of a model, made on the device from a seed.

A frozen generator of smooth motion, modelled on the first-party critter's
recording generator: within each clip every hinge and slide follows an
in-range sinusoid about its rest value, every ball joint a rotation vector
swinging about two orthogonal axes, the free root a slow wander of a few
centimetres and a gentle roll. Every clip draws its own frequencies, phases
and axes, so a session is many independent stretches of motion. Poses are
clipped into the joint box, so each frame has an exact answer. The
keypoints are the keypoint sites of the plain reference FK (float64) at
offsets moved from the model's by up to +-8 mm per coordinate (an animal's
true offsets, ``animal_offsets``), and travel in float32. The same seed
gives the same arrays.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.fk import FK
from portbench.reference.model import BALL, FREE, HINGE, SLIDE

RATE_HZ = 50.0
OFFSET_SPREAD_M = 0.008


def substream(seed: int, *keys: int) -> int:
    """A 63-bit seed for the stream ``keys`` of ``seed`` (any whole number)."""
    return int(np.random.SeedSequence([int(seed) % (1 << 128), *keys]).generate_state(1, np.uint64)[0] >> 1)


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _rotvec_quat(rv: torch.Tensor) -> torch.Tensor:
    an = torch.linalg.vector_norm(rv, dim=-1, keepdim=True) + 1e-12
    return torch.cat([torch.cos(an / 2), torch.sin(an / 2) / an * rv], dim=-1)


def animal_offsets(model, animal: int) -> np.ndarray:
    """(K, 3) the true offsets of animal number ``animal``: the model's,
    each coordinate moved by up to +-8 mm. Animals are fixed, not drawn from
    the run's seed: a session is of a given animal, and its recording's
    motion is what the seed draws."""
    rng = np.random.default_rng(substream(0, 7, animal))
    return model.initial_offsets() + rng.uniform(-OFFSET_SPREAD_M, OFFSET_SPREAD_M, (model.n_keypoints, 3))


def make_recording(fk: FK, n_clips: int, clip_frames: int, seed: int, noise_m: float = 0.0,
                   offsets: np.ndarray | None = None) -> dict:
    """{"kp": (n_clips * clip_frames, 3K) float32 on the device, "qpos": the
    true poses (float64, device), "offsets": (K, 3) float64 numpy}; the
    animal's true ``offsets`` are drawn from the seed unless given."""
    m, dev = fk.m, fk.device
    gen = torch.Generator(device=dev).manual_seed(substream(seed, 0))
    f64 = dict(dtype=torch.float64, device=dev)

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(*shape, generator=gen, **f64)

    def normal(*shape):
        return torch.randn(*shape, generator=gen, **f64)

    C, T = n_clips, clip_frames
    t = (torch.arange(T, **f64) / RATE_HZ)[None, :]  # (1, T)
    lb, ub = (torch.as_tensor(b, **f64) for b in m.box())
    q = torch.as_tensor(m.qpos0, **f64).repeat(C, T, 1)  # (C, T, nq)

    def wave(amp, lo_f=0.3, hi_f=1.2):
        f, ph = uniform(lo_f, hi_f, C, 1), uniform(0.0, 2 * math.pi, C, 1)
        return amp * torch.sin(2 * math.pi * f * t + ph)  # (C, T)

    for j, jt in enumerate(m.jnt_type):
        qa = int(m.jnt_qposadr[j])
        if jt in (HINGE, SLIDE):
            lo, hi = m.jnt_range[j]
            q[..., qa] = q[..., qa] + wave(0.4 * (hi - lo) if hi > lo else 0.7)
        elif jt == BALL:
            a1 = _unit(normal(C, 3))
            a2 = normal(C, 3)
            a2 = _unit(a2 - a1 * (a2 * a1).sum(-1, keepdim=True))
            rv = wave(0.45)[..., None] * a1[:, None] + wave(0.3)[..., None] * a2[:, None]
            q[..., qa : qa + 4] = _rotvec_quat(rv)
        elif jt == FREE:
            for c in range(3):
                q[..., qa + c] = q[..., qa + c] + wave(0.04, 0.1, 0.3)
            axis = _unit(normal(C, 3))
            q[..., qa + 3 : qa + 7] = _rotvec_quat(wave(0.2)[..., None] * axis[:, None])
    q = torch.minimum(torch.maximum(q, lb), ub).reshape(C * T, -1)

    if offsets is None:
        init = torch.as_tensor(m.initial_offsets(), **f64)
        offsets = init + uniform(-OFFSET_SPREAD_M, OFFSET_SPREAD_M, *init.shape)
    else:
        offsets = torch.as_tensor(offsets, **f64)
    kp = fk.markers(q, offsets)
    if noise_m:
        kp = kp + noise_m * normal(*kp.shape)
    return {"kp": kp.reshape(C * T, -1).to(torch.float32), "qpos": q, "offsets": offsets.cpu().numpy()}
