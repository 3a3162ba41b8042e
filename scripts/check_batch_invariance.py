#!/usr/bin/env python3
"""Which of the flat LM's batched products round alike in any batch, on a card.

    python3 scripts/check_batch_invariance.py

A clip's solve must not depend on how many clips share its batch (the
chunked ik, or a rank's block of clips): each product below is computed over
the first B of 10,000 random systems of the main path's shape (69 residuals,
37 dofs) and compared with the same rows of the 10,000-system product. The
LM computes J'J with ``torch.bmm`` and J'e with ``GNIK._gradient``; the
batched matrix-vector ``torch.bmm`` is shown for comparison. Prints one line
per product and the card's name and power limit.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SIZES = (1, 8, 20, 40, 125, 250, 256, 1280, 1500, 2000, 5000)


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
    products = {
        "J'J, torch.bmm (the LM's)": lambda B: torch.bmm(J[:B].transpose(1, 2), J[:B]),
        "J'e, GNIK._gradient (the LM's)": lambda B: GNIK._gradient(J[:B], e[:B]),
        "J'e, torch.bmm with one column": lambda B: torch.bmm(J[:B].transpose(1, 2), e[:B, :, None])[..., 0],
        "e'e, torch.sum over each row (the LM's loss)": lambda B: torch.sum(e[:B] * e[:B], dim=-1),
    }
    for name, product in products.items():
        full = product(n)
        differs = [f"B={B} (max |d| {float((product(B) - full[:B]).abs().max()):.1e})"
                   for B in SIZES if not torch.equal(product(B), full[:B])]
        print(f"{name}: " + ("bitwise equal for every B in " + str(SIZES) if not differs
                             else "differs at " + ", ".join(differs)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
