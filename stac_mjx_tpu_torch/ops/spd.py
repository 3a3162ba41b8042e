"""Batched damped SPD solve: the hand-written CUDA kernel and its plain twin.

``spd_solve(A (F, n, n), g (F, n), lam (F,) | None) -> x (F, n)`` solves
``(A + diag(lam)) x = g`` per system. It is the port of the JAX package's
Pallas kernel (``stac_mjx_tpu/ops/spd.py``: ``spd_solve_pallas_lanes``, which
the batched LM calls once per iteration, and ``spd_solve_pallas``, which the
single-frame flat LM calls). The TPU's frames-in-lanes layout and 128-frame
padding are gone: systems stay (F, n, n) row-major.

On a CUDA tensor the wrapper launches ``csrc/spd_chol.cu`` (f32 only, n up
to 128: every row in registers up to n = 96, the rows past 96 in shared
memory above) or raises; each launch runs inside a ``spd`` span
(``utils.profiling.annotate``). On a CPU tensor it takes the plain PyTorch
version, ``cholesky_ex`` + ``cholesky_solve``, which puts NaN in x wherever
the factorization failed, as the kernel and JAX's ``cho_factor`` do.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from stac_mjx_tpu_torch.ops import _build
from stac_mjx_tpu_torch.utils.profiling import annotate

# Launches of the CUDA kernel since the last reset (plain-version calls don't count).
KERNEL_LAUNCHES = 0
# The same launches by the kernel's dispatch width: n rounded up to 8, the
# case of spd_chol_solve_f32's switch that launched them.
LAUNCHES_BY_WIDTH: collections.Counter = collections.Counter()

_fn = None
_max_n = 0


def _kernel():
    """Build/load the library once; returns (C function, largest n it takes)."""
    global _fn, _max_n
    if _fn is None:
        lib = _build.load_library("spd_chol")
        fn = lib.spd_chol_solve_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.spd_chol_max_n.restype = ctypes.c_int
        _max_n = int(lib.spd_chol_max_n())
        _fn = fn
    return _fn, _max_n


def dispatch_width(n: int) -> int:
    """The case of the kernel's dispatch that solves systems of size n: n
    rounded up to 8 (``spd_chol_warp_kernel<N>`` at N = 8 ... 96; past 96,
    ``spd_chol_wide_kernel<P3>`` with P3 = 8, 16, 32 shared rows)."""
    return (n + 7) // 8 * 8


def spd_solve_plain(
    A: torch.Tensor, g: torch.Tensor, lam: torch.Tensor | None = None
) -> torch.Tensor:
    """Plain PyTorch version: batched Cholesky, NaN where it failed."""
    if lam is not None:
        eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
        A = A + lam[:, None, None] * eye
    L, info = torch.linalg.cholesky_ex(A)
    x = torch.cholesky_solve(g[..., None], L)[..., 0]
    return torch.where((info != 0)[:, None], torch.nan, x)


def spd_solve_cuda(
    A: torch.Tensor, g: torch.Tensor, lam: torch.Tensor | None = None
) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (f32, contiguous, on the card)."""
    global KERNEL_LAUNCHES
    F, n = g.shape
    tensors = (A, g) if lam is None else (A, g, lam)
    for t in tensors:
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                "spd_solve_cuda takes contiguous float32 CUDA tensors, got "
                f"{t.device} {t.dtype} contiguous={t.is_contiguous()}"
            )
        if t.device != A.device:
            raise ValueError("spd_solve_cuda: operands on different devices")
    if A.shape != (F, n, n) or (lam is not None and lam.shape != (F,)):
        raise ValueError(
            f"spd_solve_cuda: A {tuple(A.shape)}, g {tuple(g.shape)}, "
            f"lam {None if lam is None else tuple(lam.shape)} do not match"
        )
    fn, max_n = _kernel()
    if n > max_n:
        raise ValueError(f"spd_solve_cuda supports n <= {max_n}, got {n}")
    x = torch.empty_like(g)
    if F == 0:
        return x
    with torch.cuda.device(A.device), annotate("spd"):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(
            A.data_ptr(),
            g.data_ptr(),
            None if lam is None else lam.data_ptr(),
            x.data_ptr(),
            F,
            n,
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"spd_chol_solve_f32 launch failed: cudaError {rc}")
    KERNEL_LAUNCHES += 1
    LAUNCHES_BY_WIDTH[dispatch_width(n)] += 1
    return x


def spd_solve(
    A: torch.Tensor, g: torch.Tensor, lam: torch.Tensor | None = None
) -> torch.Tensor:
    """(A + diag(lam)) x = g for A (F, n, n), g (F, n), lam (F,) or None."""
    if A.is_cuda:
        return spd_solve_cuda(A, g, lam)
    return spd_solve_plain(A, g, lam)
