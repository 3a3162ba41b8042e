"""The port's CUDA kernels on the card (``cuda`` marker; skipped without a GPU).

Imports neither jax nor the JAX package, so it also runs on the GPU machine,
where jax is absent; ``tests/conftest.py`` imports jax, so skip it there:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from stac_mjx_tpu_torch.ops import spd


def _systems(F, n, seed):
    """Random J^T J + 1e-4 I systems (as the LM builds them), rhs and damping."""
    rng = np.random.default_rng(seed)
    J = rng.normal(size=(F, 3 * n, n))
    A = np.einsum("frd,fre->fde", J, J) + 1e-4 * np.eye(n)
    return (a.astype(np.float32) for a in (A, rng.normal(size=(F, n)), np.abs(rng.normal(size=(F,)))))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [6, 37, 73])
def test_cuda_kernel_matches_plain(cuda_device, n):
    """The CUDA kernel against the plain version on the card, and the guards."""
    for F in (1, 40, 1000):
        A, g, lam = _systems(F, n, seed=n * F)
        A, g, lam = (torch.as_tensor(a, device=cuda_device) for a in (A, g, lam))
        for l in (None, lam):
            before = spd.KERNEL_LAUNCHES
            x = spd.spd_solve(A, g, l)
            assert spd.KERNEL_LAUNCHES == before + 1
            want = spd.spd_solve_plain(A, g, l)
            torch.cuda.synchronize()
            # float32 Cholesky in another summation order.
            torch.testing.assert_close(x, want, rtol=2e-3, atol=2e-5)
    bad = torch.diag(torch.tensor([1.0, -1.0], device=cuda_device))[None]
    assert not torch.isfinite(spd.spd_solve(bad, torch.ones(1, 2, device=cuda_device))).any()
    with pytest.raises(ValueError):
        spd.spd_solve(A.double(), g.double())
    with pytest.raises(ValueError):
        spd.spd_solve(A.transpose(1, 2), g)
    with pytest.raises(ValueError):  # past the kernel's shared-memory budget
        big = torch.eye(97, device=cuda_device)[None].contiguous()
        spd.spd_solve(big, torch.ones(1, 97, device=cuda_device))
