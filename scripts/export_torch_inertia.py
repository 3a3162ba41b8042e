"""Export the first-party model's body masses and inertial frames for the PyTorch port.

``kinematics.subtree_com`` needs ``body_mass`` and ``body_ipos``, which the
model bundles do not carry (they stay equal to the exporter's output). This
compiles the first-party fitting model (``model=firstparty
stac=firstparty``) with the port's builder (``builder.body_inertia``, needs
mujoco, no JAX) and writes them to
``stac_mjx_tpu_torch/assets/firstparty_inertia.npz``, so a host without
mujoco can compute subtree centres of mass. ``tests/test_torch_com.py``
checks that the checked-in file equals a fresh compile.

    python scripts/export_torch_inertia.py [--out PATH]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent


def main(argv: list[str]) -> None:
    from stac_mjx_tpu_torch.bridge import INERTIA_PATH
    from stac_mjx_tpu_torch.config import compose_config
    from stac_mjx_tpu_torch.models.builder import body_inertia

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=INERTIA_PATH, help="default: %(default)s")
    args = ap.parse_args(argv)
    cfg = compose_config(REPO / "configs", overrides=["model=firstparty", "stac=firstparty"])
    body_mass, body_ipos = body_inertia(cfg, REPO)
    np.savez(args.out, body_mass=body_mass, body_ipos=body_ipos)
    print(f"wrote {args.out} ({args.out.stat().st_size} bytes)")


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    main(sys.argv[1:])
