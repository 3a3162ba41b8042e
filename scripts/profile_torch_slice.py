"""Where the PyTorch port's main path spends its time on the GPU.

Runs the fit (250 frames) and the hierarchical ik (10,000 frames in 40
clips) of ``chip_smoke.py``'s configuration twice each: once untraced for
the wall time, once under ``torch.profiler``. For each phase it prints the
wall seconds (untraced and traced), the device busy time (the sum of kernel
durations; everything runs on one stream, so kernels do not overlap), the
idle share of the traced wall time, the kernel launch count, the SPD
kernel's device time and launches, and the kernels that take the most
device time. The full kernel and operator tables go
under ``--out``.

    python3 scripts/profile_torch_slice.py [--out DIR]   (default: profile_out/)
"""

from __future__ import annotations

import argparse
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def _kernel_stats(prof) -> tuple[float, int, list]:
    """(device busy seconds, kernel launches, [(name, count, seconds)] by time)."""
    per = defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dur = (e.time_range.end - e.time_range.start) * 1e-6
            per[e.name][0] += 1
            per[e.name][1] += dur
    rows = sorted(((k, c, t) for k, (c, t) in per.items()), key=lambda r: -r[2])
    return sum(r[2] for r in rows), sum(r[1] for r in rows), rows


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "profile_out"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_slice: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from chip_smoke import CLIP, N_FIT, N_IK, THROUGHPUT
    from stac_mjx_tpu_torch.bridge import load_bundle
    from stac_mjx_tpu_torch.models.firstparty import make_recording
    from stac_mjx_tpu_torch.stac import Stac

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    device = torch.device("cuda:0")
    bundle = load_bundle()
    kp, _, _, _ = make_recording(bundle, n_frames=N_IK, seed=0, device=device)
    stac = Stac(bundle, dict(THROUGHPUT, n_fit_frames=N_FIT, n_frames_per_clip=CLIP), device=device)
    offsets = stac.fit_offsets(kp[:N_FIT]).offsets  # warm-up, and the ik's offsets
    phases = {
        "fit": lambda: stac.fit_offsets(kp[:N_FIT]),
        "ik": lambda: stac.ik_only(kp, offsets),
    }
    frames = {"fit": N_FIT, "ik": N_IK}
    for name, fn in phases.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            traced = time.perf_counter() - t0
        busy, launches, rows = _kernel_stats(prof)
        print(f"{name}: {frames[name]} frames, wall {wall:.4f} s untraced ({frames[name] / wall:.1f} frames/s), "
              f"{traced:.4f} s traced; device busy {busy * 1e3:.3f} ms, idle share "
              f"{1 - busy / traced:.4f} of the traced wall; {launches} kernel launches")
        spd = [(c, t) for k, c, t in rows if "spd_chol" in k]
        print(f"  SPD kernel (spd_chol_*): {sum(t for _, t in spd) * 1e3:.3f} ms device time "
              f"over {sum(c for c, _ in spd)} launches")
        for kname, count, t in rows[:12]:
            print(f"  {t * 1e3:9.3f} ms {count:7d}x  {kname[:110]}")
        (out / f"{name}_kernels.txt").write_text(
            "\n".join(f"{t * 1e3:.4f} ms\t{c}\t{k}" for k, c, t in rows)
        )
        (out / f"{name}_ops.txt").write_text(
            prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=60)
        )
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
