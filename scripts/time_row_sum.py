#!/usr/bin/env python3
"""The main path's walls with each layout of the LM's row sums, in turns, on a card.

    python3 scripts/time_row_sum.py [--reps 7]

``GNIK._row_sum`` (the loss e'e, the predicted gain, the step norm of the
flat LM) is swapped in turn for each layout of ``LAYOUTS`` in
``scripts/check_batch_invariance.py`` named below: ``torch.sum(dim=-1)``
(what the LM ran before its row sums were made batch-invariant), the
zero-padded pairwise sum and the broadcast layout (the LM's now). With each, in turns
(A B C, C B A, ...), the main path of ``chip_smoke.py`` runs on a
``Stac`` made once: the fit on the first 250 frames of a 10,000-frame
recording made on the card from seed 0, then the ik on all 10,000 frames in
40 clips of 250 (walls between card synchronisations, after a warm-up).
Then, for each layout, the ik of the 40 clips in chunks of 5 and of the
first 8 clips in chunks of 1 against that layout's one batch (bitwise or
not). Prints the card's name and power limit, a line per run, and per layout
the median walls, the residuals and K1's launches.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "scripts")]

RUN = ("torch.sum(dim=-1)", "pairwise, zero-padded", "broadcast to 32, sum(-2)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=7, help="runs of each layout, in turns")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_row_sum: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from check_batch_invariance import LAYOUTS
    from stac_mjx_tpu_torch.bridge import load_bundle
    from stac_mjx_tpu_torch.models.firstparty import make_recording
    from stac_mjx_tpu_torch.ops import spd
    from stac_mjx_tpu_torch.ops.gn_ik import GNIK
    from stac_mjx_tpu_torch.stac import Stac

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0])
    dev = torch.device("cuda:0")
    spd._kernel()
    bundle = load_bundle()
    kp, _, true_off, _ = make_recording(bundle, n_frames=cs.N_IK, seed=0, device=dev)
    kp_host = kp.cpu().numpy()
    cfg = dict(cs.THROUGHPUT, n_fit_frames=cs.N_FIT, n_frames_per_clip=cs.CLIP)
    stac = Stac(bundle, cfg, device=dev)
    warm = Stac(bundle, dict(cfg, n_frames_per_clip=16), model={"N_ITERS": 1}, device=dev)
    warm.ik_only(kp[:32], warm.fit_offsets(kp[:16]).offsets)

    own = GNIK.__dict__["_row_sum"]
    runs = {name: [] for name in RUN}
    order = [name for r in range(args.reps) for name in (RUN if r % 2 == 0 else RUN[::-1])]
    try:
        for name in order:
            GNIK._row_sum = staticmethod(LAYOUTS[name])
            spd.KERNEL_LAUNCHES = 0
            fit, fit_s = cs._sync_time(lambda: stac.fit_offsets(kp[: cs.N_FIT]))
            n_fit = spd.KERNEL_LAUNCHES
            ik, ik_s = cs._sync_time(lambda: stac.ik_only(kp, fit.offsets))
            _, _, ik_markers = stac.compute_full_outputs(ik.qpos)
            q = (cs._resid(fit.marker_sites, fit.kp_data, cs.N_FIT), cs._resid(ik_markers, kp_host, cs.N_IK),
                 float(np.abs(fit.offsets - true_off).mean()))
            runs[name].append((fit_s, ik_s, q, (n_fit, spd.KERNEL_LAUNCHES - n_fit), fit.offsets, ik.qpos))
            print(f"{name}: fit {fit_s:.4f} s, ik {ik_s:.4f} s; fit/ik residual {q[0] * 1e3:.4f}/{q[1] * 1e3:.4f} mm, "
                  f"offset error {q[2] * 1e3:.4f} mm; K1 launches {n_fit} + {spd.KERNEL_LAUNCHES - n_fit}")

        for name in RUN:
            GNIK._row_sum = staticmethod(LAYOUTS[name])
            offsets, one = runs[name][0][4], runs[name][0][5]
            same = {}
            for chunk, n_clips in ((5, cs.N_IK // cs.CLIP), (1, 8)):
                st = Stac(bundle, dict(cfg, ik_chunk_clips=chunk), device=dev)
                ik = st.ik_only(kp[: n_clips * cs.CLIP], offsets)
                same[f"chunks of {chunk} ({n_clips} clips)"] = float(np.abs(ik.qpos - one[: n_clips * cs.CLIP]).max())
            r = runs[name]
            print(f"{name}: median of {len(r)} fit {statistics.median(x[0] for x in r):.4f} s "
                  f"(all {', '.join(f'{x[0]:.4f}' for x in r)}), ik {statistics.median(x[1] for x in r):.4f} s "
                  f"(all {', '.join(f'{x[1]:.4f}' for x in r)}); residuals {', '.join(f'{v * 1e3:.4f}' for v in r[0][2])} "
                  f"mm; K1 launches {r[0][3]}; ik max |qpos delta| against one batch: "
                  + ", ".join(f"{k} {v:.3e}" for k, v in same.items()))
    finally:
        GNIK._row_sum = own
    return 0


if __name__ == "__main__":
    sys.exit(main())
