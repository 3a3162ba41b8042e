"""Synthetic-data demo on the PyTorch port (after ``demos/synth_data_demo.py``).

Drives the single-keypoint synth model through a known trajectory,
synthesizes its keypoint by the port's forward kinematics with the
configured marker offset, fits it back with ``Stac.fit_offsets`` (lockstep
pose mode, the linesearch Gauss-Newton solver, whose damped solves run the
CUDA kernel on the card) and reports the mean marker residual and the
largest error of the recovered translation.

    python demos/torch_synth_data_demo.py          # on the card; raises without one
    python demos/torch_synth_data_demo.py --cpu
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
N_FRAMES = 50


def run(device: torch.device | str = "cuda") -> dict:
    """The demo's fit: {"residual" (m), "drift" (m), "fit" (StacData), "kp"
    (N_FRAMES, 3) m, "qs" (N_FRAMES, nq) the true trajectory}."""
    from stac_mjx_tpu_torch.config import compose_config
    from stac_mjx_tpu_torch.main import make_stac

    cfg = compose_config(
        REPO / "configs",
        overrides=[
            "stac=synth",
            "model=synth_data",
            f"stac.n_fit_frames={N_FRAMES}",
            f"stac.n_frames_per_clip={N_FRAMES}",
            "stac.q_solver=gn",
            "stac.pose_mode=lockstep",
        ],
    )
    stac = make_stac(cfg, list(cfg.model.KP_NAMES), device=device, base_path=REPO)

    # A known trajectory: the free body slides along x and bobs in z.
    t = np.linspace(0, 2 * np.pi, N_FRAMES)
    qs = np.tile(stac.params.qpos0.cpu().numpy(), (N_FRAMES, 1))
    qs[:, 0] = 0.2 * np.sin(t)
    qs[:, 2] = 0.3 + 0.05 * np.cos(t)

    # The keypoint by FK with the configured initial marker offset.
    q = torch.as_tensor(qs, dtype=torch.float32, device=stac.device)
    site_xpos = stac.stac_core_obj.fk(stac.params, q).site_xpos[:, stac._body_site_idxs]
    kp = site_xpos.reshape(N_FRAMES, -1)

    fit = stac.fit_offsets(kp)
    kp = kp.cpu().numpy()
    residual = np.linalg.norm(
        fit.marker_sites.reshape(N_FRAMES, -1, 3) - kp.reshape(N_FRAMES, -1, 3), axis=-1
    ).mean()
    drift = np.abs(fit.qpos[:, :3] - qs[:, :3]).max()
    return {"residual": float(residual), "drift": float(drift), "fit": fit, "kp": kp, "qs": qs}


def report(out: dict) -> None:
    print(f"mean marker residual after fit: {out['residual'] * 1000:.4f} mm")
    print(f"max recovered-translation error: {out['drift'] * 1000:.4f} mm")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    report(run("cpu" if args.cpu else "cuda"))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    raise SystemExit(main())
