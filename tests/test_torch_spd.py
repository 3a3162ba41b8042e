"""The port's batched SPD solve against the JAX package's.

On the CPU the port's ``spd_solve`` takes its plain version (cholesky_ex +
cholesky_solve); it is held against ``spd_solve_xla`` and
``_spd_solve_xla_lanes`` in float64 and float32, and against the Pallas
kernel in interpret mode at a small size. The CUDA kernel itself is held
against the plain version in ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import x64_mode
from _torch_spd_cases import indefinite_batch
from stac_mjx_tpu.ops.spd import _spd_solve_xla_lanes, spd_solve_pallas_lanes, spd_solve_xla
from stac_mjx_tpu_torch.ops import spd


def _systems(F, n, seed, dtype=np.float64):
    """Random J^T J + 1e-4 I systems (as the LM builds them), rhs and damping."""
    rng = np.random.default_rng(seed)
    J = rng.normal(size=(F, 3 * n, n))
    A = np.einsum("frd,fre->fde", J, J) + 1e-4 * np.eye(n)
    g = rng.normal(size=(F, n))
    lam = np.abs(rng.normal(size=(F,)))
    return A.astype(dtype), g.astype(dtype), lam.astype(dtype)


def _jax_solve(A, g, lam):
    if lam is None:
        return np.asarray(spd_solve_xla(jnp.asarray(A), jnp.asarray(g)))
    x = _spd_solve_xla_lanes(
        jnp.asarray(np.transpose(A, (1, 2, 0))), jnp.asarray(g.T), jnp.asarray(lam)
    )
    return np.asarray(x).T


CASES = [(6, 130), (37, 7), (73, 9)]  # (n, F): F never a multiple of 128


@pytest.mark.parametrize("with_lam", [False, True], ids=["nolam", "lam"])
@pytest.mark.parametrize("n,F", CASES)
def test_plain_matches_xla_f64(n, F, with_lam):
    A, g, lam = _systems(F, n, seed=n + F)
    lam = lam if with_lam else None
    with x64_mode():
        want = _jax_solve(A, g, lam)
    got = spd.spd_solve(
        torch.as_tensor(A), torch.as_tensor(g), None if lam is None else torch.as_tensor(lam)
    )
    # Two float64 Cholesky solves of well-conditioned systems.
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("with_lam", [False, True], ids=["nolam", "lam"])
@pytest.mark.parametrize("n,F", CASES)
def test_plain_matches_xla_f32(n, F, with_lam):
    A, g, lam = _systems(F, n, seed=n + F, dtype=np.float32)
    lam = lam if with_lam else None
    want = _jax_solve(A, g, lam)
    got = spd.spd_solve(
        torch.as_tensor(A), torch.as_tensor(g), None if lam is None else torch.as_tensor(lam)
    )
    # The tolerance tests/test_spd.py holds the Pallas kernel to.
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-5)


def test_plain_matches_pallas_interpret():
    """The TPU kernel itself (interpret mode; kept small as in test_spd.py)."""
    A, g, lam = _systems(5, 12, seed=4, dtype=np.float32)
    want = np.asarray(
        spd_solve_pallas_lanes(
            jnp.asarray(np.transpose(A, (1, 2, 0))), jnp.asarray(g.T), jnp.asarray(lam), interpret=True
        )
    ).T
    got = spd.spd_solve(torch.as_tensor(A), torch.as_tensor(g), torch.as_tensor(lam))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-5)


def test_indefinite_gives_nan_in_both_packages():
    """No pivoting, no flag: a non-positive pivot gives a non-finite x,
    which the LM accept test rejects."""
    A, g, _ = _systems(3, 4, seed=0)
    A[1] = np.diag([1.0, -2.0, 3.0, 4.0])
    want = np.asarray(spd_solve_xla(jnp.asarray(A, jnp.float32), jnp.asarray(g, jnp.float32)))
    got = spd.spd_solve(torch.as_tensor(A, dtype=torch.float32), torch.as_tensor(g, dtype=torch.float32))
    assert not np.isfinite(want[1]).any() and not np.isfinite(got[1].numpy()).any()
    assert np.isfinite(got[[0, 2]].numpy()).all()
    np.testing.assert_allclose(got[[0, 2]].numpy(), want[[0, 2]], rtol=2e-3, atol=2e-5)


@pytest.mark.parametrize("n", [6, 37, 73])
def test_plain_isolates_the_indefinite_system(n):
    """Only the middle system fails (at column n // 2): only its x is
    non-finite, the others are the float64 solve."""
    A, g, mid = indefinite_batch(9, n, seed=n)
    x = spd.spd_solve_plain(torch.as_tensor(A), torch.as_tensor(g)).numpy()
    assert not np.isfinite(x[mid]).any()
    rest = [f for f in range(9) if f != mid]
    np.testing.assert_allclose(x[rest], np.linalg.solve(A[rest], g[rest][..., None])[..., 0], rtol=1e-8, atol=1e-10)


def test_cpu_never_launches_the_kernel():
    before = spd.KERNEL_LAUNCHES
    A, g, lam = _systems(4, 5, seed=1)
    spd.spd_solve(torch.as_tensor(A), torch.as_tensor(g), torch.as_tensor(lam))
    assert spd.KERNEL_LAUNCHES == before
