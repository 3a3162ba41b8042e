#!/usr/bin/env python3
"""Which of the flat LM's batched products round alike in any batch, on a card.

    python3 scripts/check_batch_invariance.py

A clip's solve must not depend on how many clips share its batch (the
chunked ik, or a rank's block of clips): each product below is computed over
the first B of 10,000 random systems of the main path's shape (69 residuals,
37 dofs, 44 qpos coordinates) and compared with the same rows of the
10,000-system product. The LM computes J'J with ``torch.bmm`` and J'e with
``GNIK._gradient``; the batched matrix-vector ``torch.bmm`` is shown for
comparison. Its row sums (the loss e'e, the predicted gain
delta.(lam delta - g), the step norm d'd) go through ``GNIK._row_sum``; each
row sum is also shown in the candidate layouts (``LAYOUTS``), with its time
per call at B = 10,000 (CUDA events). Prints one line per product and the
card's name and power limit.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SIZES = tuple(range(1, 17)) + (20, 40, 125, 250, 256, 1280, 1500, 2000, 5000)


def _sum_last(x):
    return torch.sum(x, dim=-1)


def _column_major(x):
    """(n, F) layout, reduced over dim 0."""
    return x.t().contiguous().sum(0)


def _size_one_dim(x):
    """A trailing size-1 dim, reduced over the columns: TensorIterator folds it."""
    return x[..., None].sum(-2)[..., 0]


def _pairwise(x):
    """The columns padded with zeros to a power of two and halved by
    elementwise adds: one fixed order, log2 of the padded width + 1 launches."""
    m = 1 << (x.shape[-1] - 1).bit_length()
    x = torch.nn.functional.pad(x, (0, m - x.shape[-1]))
    while m > 1:
        m //= 2
        x = x[..., :m] + x[..., m:]
    return x[..., 0]


def _broadcast(width: int):
    """Each row broadcast to ``width`` columns (a stride-0 view) and reduced
    over the middle dim: the layout of ``GNIK._gradient`` (a reduction over
    dim 1 with a trailing dim of nv outputs per frame), one launch."""

    def row_sum(x):
        return x[..., None].expand(*x.shape, width).sum(-2)[..., 0]

    return row_sum


def _gemv(x):
    """x @ ones(n): cuBLAS's matrix-vector product."""
    return x @ torch.ones(x.shape[-1], dtype=x.dtype, device=x.device)


# The candidates beside the LM's own (GNIK._row_sum).
LAYOUTS = {
    "torch.sum(dim=-1)": _sum_last,
    "column-major (n, F) sum(0)": _column_major,
    "x[..., None].sum(-2)": _size_one_dim,
    "pairwise, zero-padded": _pairwise,
    "broadcast to 8, sum(-2)": _broadcast(8),
    "broadcast to 32, sum(-2)": _broadcast(32),
    "x @ ones(n)": _gemv,
}


def _ms_per_call(fn, reps: int = 50) -> float:
    for _ in range(3):
        fn()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("check_batch_invariance: needs a CUDA device", file=sys.stderr)
        return 1
    from stac_mjx_tpu_torch.ops.gn_ik import GNIK

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0])
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(5)
    n = 10_000
    J = torch.randn(n, 69, 37, generator=gen, device=dev)
    e = torch.randn(n, 69, generator=gen, device=dev)
    delta = torch.randn(n, 37, generator=gen, device=dev)
    g = torch.randn(n, 37, generator=gen, device=dev)
    lam = torch.rand(n, generator=gen, device=dev)
    d = torch.randn(n, 44, generator=gen, device=dev)
    products = {
        "J'J, torch.bmm (the LM's)": lambda B: torch.bmm(J[:B].transpose(1, 2), J[:B]),
        "J'e, GNIK._gradient (the LM's)": lambda B: GNIK._gradient(J[:B], e[:B]),
        "J'e, torch.bmm with one column": lambda B: torch.bmm(J[:B].transpose(1, 2), e[:B, :, None])[..., 0],
    }
    row_sums = {
        "e'e (loss, n=69)": lambda B: e[:B] * e[:B],
        "delta.(lam delta - g) (predicted gain, n=37)": lambda B: delta[:B] * (lam[:B, None] * delta[:B] - g[:B]),
        "d'd (step norm, n=44)": lambda B: d[:B] * d[:B],
    }
    layouts = dict(LAYOUTS, **{"GNIK._row_sum (the LM's)": GNIK._row_sum})
    timed = {}  # product name -> (reduction, its terms at B = n)
    for row, terms in row_sums.items():
        for how, reduce in layouts.items():
            products[f"{row}, {how}"] = lambda B, terms=terms, reduce=reduce: reduce(terms(B))
            timed[f"{row}, {how}"] = (reduce, terms(n))
    for name, product in products.items():
        full = product(n)
        differs = [f"B={B} (max |d| {float((product(B) - full[:B]).abs().max()):.1e})"
                   for B in SIZES if not torch.equal(product(B), full[:B])]
        line = (f"bitwise equal for every B in {SIZES}" if not differs
                else f"differs at {len(differs)} of {len(SIZES)} sizes: " + ", ".join(differs))
        if name in timed:
            reduce, x = timed[name]
            line += f"; {_ms_per_call(lambda: reduce(x)):.4f} ms per call at B={n}"
        print(f"{name}: {line}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
