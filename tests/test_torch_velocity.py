"""The port's qvel inference (``utils/velocity.py``) against the JAX
package's, which the driver maps over clips with ``jax.vmap``.

Bounds. float64: 1e-12 (absolute, in m/s and rad/s; relative for the larger
values). float32: translation and joint columns to 1e-3 relative (both sides
difference the same float32 values; the division rounds once); gyro columns
to GYRO_F32_BOUND = 2 sqrt(2 * 2^-23) / dt = 0.488 rad/s at dt = 0.002 s.
Near the identity the float32 w of the normalised quaternion difference
comes out within 2 ulps (2^-23) of its exact value; where it rounds to 1,
``quat_to_axisangle`` returns the zero rotation (below ``_TOL``) while an
exact computation returns ~2|v|, with |v| = sqrt(2 (1 - w)) up to
sqrt(2 * 2^-23). ``test_f32_gyro_bound_covers_near_identity_rounding``
samples such pairs; elsewhere the float32 gyro is within GYRO_F32_REST.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import x64_mode
from stac_mjx_tpu.utils import velocity as jvel
from stac_mjx_tpu_torch.utils.velocity import compute_velocity_from_kinematics

DT = 0.002  # the firstparty bundle's timestep
GYRO_F32_BOUND = 0.49  # rad/s, where float32 w rounds to 1; see the module docstring
GYRO_F32_REST = 1e-2  # rad/s elsewhere: float32 rounding of v (a few 2^-24) times 2 / dt is ~1e-4
C, T, NQ = 3, 24, 44  # firstparty's nq: qvel has nq - 1 = 43 columns


def _qmul(a, b):
    w1, x1, y1, z1 = np.moveaxis(a, -1, 0)
    w2, x2, y2, z2 = np.moveaxis(b, -1, 0)
    return np.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        axis=-1,
    )


def _track(kind: str, seed: int) -> np.ndarray:
    """(C, T, NQ) float64 qpos: a wandering root, its quaternion driven by
    per-frame rotations of the given kind, and joint columns whose steps pass
    the +-20 clip."""
    rng = np.random.default_rng(seed)
    q = np.zeros((C, T, NQ))
    q[..., :3] = np.cumsum(rng.normal(0, 2e-4, (C, T, 3)), axis=1)
    if kind == "near_identity":  # 1e-9 .. 1e-3 rad per frame
        ang = 10.0 ** rng.uniform(-9, -3, (C, T))
    elif kind == "near_pi":  # pi - 1e-6 .. pi - 1e-1, and past pi
        ang = np.pi + rng.choice([-1, 1], (C, T)) * 10.0 ** rng.uniform(-6, -1, (C, T))
    else:  # a mix of ordinary motion and exact repeats
        ang = rng.uniform(0, 0.05, (C, T)) * (rng.uniform(size=(C, T)) > 0.2)
    axis = rng.normal(size=(C, T, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    step = np.concatenate([np.cos(ang / 2)[..., None], np.sin(ang / 2)[..., None] * axis], axis=-1)
    quat = np.zeros((C, T, 4))
    quat[:, 0] = [1.0, 0.0, 0.0, 0.0]
    for t in range(1, T):
        quat[:, t] = _qmul(quat[:, t - 1], step[:, t])
    # q and -q are one rotation: flip some signs, so quat_diff sees w < 0.
    quat *= np.where(rng.uniform(size=(C, T, 1)) < 0.3, -1.0, 1.0)
    q[..., 3:7] = quat
    q[..., 7:] = np.cumsum(rng.normal(0, 0.05, (C, T, NQ - 7)), axis=1)  # ~25 rad/s steps
    return q


def _jax(q: np.ndarray, freejoint: bool) -> np.ndarray:
    """As the JAX driver runs it: ``jax.vmap`` over clips, not jitted."""
    out = jax.vmap(lambda qs: jvel.compute_velocity_from_kinematics(qs, dt=DT, freejoint=freejoint))(jnp.asarray(q))
    return np.asarray(out)


def _port(q: np.ndarray, freejoint: bool) -> np.ndarray:
    return compute_velocity_from_kinematics(torch.as_tensor(q), dt=DT, freejoint=freejoint).numpy()


KINDS = ("near_identity", "near_pi", "mixed")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("freejoint", [True, False])
def test_qvel_matches_jax_f64(kind, freejoint):
    q = _track(kind, seed=KINDS.index(kind))
    with x64_mode():
        want = _jax(q, freejoint)
    got = _port(q, freejoint)
    assert got.dtype == want.dtype == np.float64
    assert got.shape == want.shape == ((C, T, NQ - 1) if freejoint else (C, T, NQ))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    joints = got[..., 6:] if freejoint else got
    assert np.abs(joints).max() == 20.0  # the clip is hit, and holds
    if freejoint and kind == "near_pi":
        assert np.abs(got[..., 3:6]).max() > 20.0  # the gyro columns are not clipped
    if freejoint:
        np.testing.assert_array_equal(got[:, -1], np.zeros_like(got[:, -1]))  # last frame repeated


@pytest.mark.parametrize("kind", KINDS)
def test_qvel_matches_jax_f32(kind):
    q = _track(kind, seed=10 + KINDS.index(kind)).astype(np.float32)
    want = _jax(q, True)
    got = _port(q, True)
    assert got.dtype == want.dtype == np.float32
    lin = np.r_[0:3, 6 : NQ - 1]
    np.testing.assert_allclose(got[..., lin], want[..., lin], rtol=1e-3, atol=0)
    assert np.abs(got[..., 3:6] - want[..., 3:6]).max() <= GYRO_F32_BOUND


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batch_equals_per_clip_calls(dtype):
    q = torch.as_tensor(_track("mixed", seed=7)).to(dtype)
    batch = compute_velocity_from_kinematics(q, dt=DT)
    for c in range(C):
        np.testing.assert_array_equal(batch[c].numpy(), compute_velocity_from_kinematics(q[c], dt=DT).numpy())


def test_f32_gyro_bound_covers_near_identity_rounding():
    """5 x 10^5 pairs of quaternions a small rotation apart (0 to 2e-3 rad per
    frame, the slow end of a 500 Hz root), unit and scaled as the crossfade
    leaves them (norms 0.7-1): the float32 gyro against float64 on the same
    float32 values."""
    rng = np.random.default_rng(0)
    n = 500_000
    q0 = rng.normal(size=(n, 4))
    q0 /= np.linalg.norm(q0, axis=1, keepdims=True)
    ang = rng.uniform(0, 2e-3, n)
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    q1 = _qmul(q0, np.concatenate([np.cos(ang / 2)[:, None], np.sin(ang / 2)[:, None] * axis], axis=1))
    scale = np.where(np.arange(n) % 2 == 0, 1.0, rng.uniform(0.7, 1.0, n))[:, None]
    qpos = np.zeros((n, 2, 7))
    qpos[:, 0, 3:], qpos[:, 1, 3:] = q0 * scale, q1 * scale
    q32 = torch.as_tensor(qpos.astype(np.float32))
    g32 = compute_velocity_from_kinematics(q32, dt=DT)[:, 0, 3:6].double().numpy()
    g64 = compute_velocity_from_kinematics(q32.double(), dt=DT)[:, 0, 3:6].numpy()
    err = np.abs(g32 - g64).max(axis=1)
    zero = (g32 == 0).all(axis=1)
    assert zero.sum() > 100  # the rounding to w = 1 does happen
    assert err[zero].max() <= GYRO_F32_BOUND
    assert err[~zero].max() <= GYRO_F32_REST
    print(f"float32 gyro error: {err[zero].max():.4f} rad/s max over {zero.sum()} zero-rotation pairs, "
          f"{err[~zero].max():.3e} over the others")
