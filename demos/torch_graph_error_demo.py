"""Registration-quality analysis on the PyTorch port (after ``demos/graph_error_demo.py``).

Loads a STAC output file (written by either package), recomputes the
per-frame summed squared marker error by forward kinematics with the fitted
offsets, in one batched FK over all frames, then reports

- the error's mean and spread, and the frames whose error exceeds a
  threshold ("not good offset frames"),
- the per-frame qpos change, split into clip-seam frames and mid-clip frames,
- with plots (matplotlib, imported only then): error against frame, a
  log-scale error histogram, and the qpos change at seams against mid-clip.

    python demos/torch_graph_error_demo.py <output.h5> [--cpu] [--threshold 0.005]
                                           [--clip-len 360] [--save-prefix errors] [--no-plots]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]


def recompute_errors(data_path, base_path=REPO, device: torch.device | str = "cuda", dtype: torch.dtype = torch.float32):
    """(per-frame summed squared marker error (F,) recomputed by FK, StacData).

    The model is the one of the file's config (``main.make_stac``: a
    checked-in bundle, or its MJCF under ``base_path`` compiled); the
    offsets are the file's. Runs on the card unless ``device`` says
    otherwise."""
    from stac_mjx_tpu_torch import io
    from stac_mjx_tpu_torch.main import make_stac

    cfg, d = io.load_stac_data(data_path)
    stac = make_stac(cfg, d.kp_names, device=device, dtype=dtype, base_path=base_path)
    core = stac.stac_core_obj
    params = stac.params.set_site_pos(
        torch.as_tensor(d.offsets.reshape(-1, 3), device=stac.device), core.site_idxs_t
    )
    qpos = torch.as_tensor(np.asarray(d.qpos), device=stac.device).to(dtype)
    kps = torch.as_tensor(np.asarray(d.kp_data[: d.qpos.shape[0]]), device=stac.device).to(dtype)
    markers = core.fk(params, qpos).site_xpos[:, core.site_idxs_t].reshape(qpos.shape[0], -1)
    errors = torch.sum(torch.square(kps - markers), dim=-1)
    return errors.cpu().numpy(), d


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("data_path", help="STAC fit/ik output .h5")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    ap.add_argument("--threshold", type=float, default=0.005)
    ap.add_argument("--clip-len", type=int, default=360)
    ap.add_argument("--save-prefix", default="graph_error")
    ap.add_argument("--no-plots", action="store_true")
    args = ap.parse_args(argv)

    errors, d = recompute_errors(args.data_path, device="cpu" if args.cpu else "cuda")
    n = errors.shape[0]
    print(f"mean: {errors.mean()}, std: {errors.std()}")
    bad = np.where(errors > args.threshold)[0]
    print(f"there are {bad.shape[0]} not good offset frames (>{args.threshold})")

    qpos_diff_summed = np.abs(np.diff(d.qpos, axis=0)).sum(axis=1)
    seam = np.array([(i + 1) % args.clip_len <= 5 for i in range(n - 1)])
    if seam.any() and (~seam).any():
        print(
            f"qpos change at clip seams: {qpos_diff_summed[seam].mean():.4f} "
            f"vs mid-clip: {qpos_diff_summed[~seam].mean():.4f}"
        )

    if not args.no_plots:
        import matplotlib

        matplotlib.use("Agg")
        from matplotlib import pyplot as plt

        fig, axes = plt.subplots(1, 3, figsize=(15, 4))
        axes[0].scatter(np.arange(n), errors, s=1)
        axes[0].set(
            title="Summed squared error of frame marker offset",
            xlabel="Frame #",
            ylabel="Summed squared error",
            ylim=(0, max(0.02, float(np.percentile(errors, 99)) * 1.5)),
        )
        axes[1].hist(errors, bins=100, log=True)
        axes[1].set(title="Histogram of errors", xlabel="error value", ylabel="frames")
        axes[2].hist(qpos_diff_summed[seam], bins=100, log=True, alpha=0.5, label="seam")
        axes[2].hist(qpos_diff_summed[~seam], bins=100, log=True, alpha=0.5, label="mid")
        axes[2].set(title="qpos change: clip seams vs mid", xlabel="sum |dqpos|")
        axes[2].legend()
        out = Path(f"{args.save_prefix}.png")
        fig.tight_layout()
        fig.savefig(out, dpi=120)
        plt.close(fig)
        print(f"plots: {out}")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    raise SystemExit(main())
