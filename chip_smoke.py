#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100), from a checkout.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. device: needs CUDA; prints the card's name and power limit (nvidia-smi);
2. build: compiles csrc/spd_chol.cu with nvcc (the batched-Cholesky kernel);
3. kernel: the CUDA kernel against its plain PyTorch version and a float64
   solve, at the shapes the main path gives it; times both with CUDA events;
4. main path: the bench's throughput configuration (lockstep flat LM,
   pointer-doubling FK, no part passes, hierarchical ik 8/6) on the
   first-party model: a 10,000-frame recording made on the card, the fit on
   its first 250 frames, then ik on all 10,000 frames in 40 clips of 250;
   the kernel's launch count must rise in both; residuals and the offset
   error against the ground truth must stay under stated bounds;
5. reference: a small fit + ik on the card against the same run on the CPU
   in float64 (the path the CPU tests hold against the JAX package).

The second-to-last line is {"kernels": [...]} and the last line
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# The bench's throughput configuration (bench.py), at its data size.
THROUGHPUT = {
    "pose_mode": "lockstep",
    "q_solver": "gn-lm",
    "skip_part_opt": True,
    "fk_impl": "jump",
    "continuous": False,
    "ik_hier_stride": 8,
    "ik_hier_fine_iters": 6,
    "ik_return_full": False,
}
N_FIT, CLIP, N_IK = 250, 250, 10_000
# Bounds on clean (noise-free) firstparty data, in meters. The same run on
# the CPU with a 1,000-frame ik gives a fit residual of 2.17 mm, an ik
# residual of 1.54 mm and an offset error of 2.32 mm; the bounds leave a
# 2.3x margin over the largest.
FIT_RESID_MAX = 5e-3
IK_RESID_MAX = 5e-3
OFFSET_ERR_MAX = 5e-3
KERNEL_REL_TOL = 1e-4  # f32 Cholesky vs f32 cholesky_ex / f64 solve, max |dx| / max |x|


def _sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _resid(markers, kp, n) -> float:
    d = np.reshape(markers, (n, -1, 3)) - np.reshape(kp, (n, -1, 3))
    return float(np.linalg.norm(d, axis=-1).mean())


def _systems(F, n, gen, device):
    J = torch.randn(F, 3 * n, n, generator=gen).to(device)
    A = (J.mT @ J + 1e-4 * torch.eye(n, device=device)).contiguous()
    g = torch.randn(F, n, generator=gen).to(device)
    lam = torch.rand(F, generator=gen).to(device)
    return A, g, lam


def phase_kernel(spd, device) -> dict:
    gen = torch.Generator().manual_seed(0)
    worst = 0.0
    main_err = None
    shapes = [(6, F) for F in (1, 40, 1000, 10_000)]
    shapes += [(37, F) for F in (1, 40, 250, 1000, 1250, 10_000)]
    shapes += [(73, F) for F in (1, 40, 1000, 10_000)]
    for n, F in shapes:
        A, g, lam = _systems(F, n, gen, device)
        eye = torch.eye(n, device=device, dtype=torch.float64)
        for lam_ in (None, lam):
            x = spd.spd_solve(A, g, lam_)
            plain = spd.spd_solve_plain(A, g, lam_)
            A64 = A.double() + (0 if lam_ is None else lam_.double()[:, None, None] * eye)
            x64 = torch.linalg.solve(A64, g.double())
            torch.cuda.synchronize()
            scale = float(plain.abs().max())
            err_plain = float((x - plain).abs().max()) / scale
            err_f64 = float((x.double() - x64).abs().max()) / float(x64.abs().max())
            print(f"kernel n={n:2d} F={F:5d} lam={lam_ is not None!s:5}: "
                  f"rel err vs plain {err_plain:.3e}, vs f64 {err_f64:.3e}")
            if not (err_plain < KERNEL_REL_TOL and err_f64 < KERNEL_REL_TOL):
                raise AssertionError(f"kernel disagrees at n={n} F={F} (bound {KERNEL_REL_TOL})")
            worst = max(worst, err_plain)
            if (n, F) == (37, 10_000) and lam_ is not None:
                main_err = float((x - plain).abs().max())
    bad = torch.diag(torch.tensor([1.0, -2.0, 3.0], device=device))[None].contiguous()
    xb = spd.spd_solve(bad, torch.ones(1, 3, device=device))
    torch.cuda.synchronize()
    if torch.isfinite(xb).any():
        raise AssertionError(f"indefinite system gave a finite x: {xb}")
    print(f"kernel: indefinite system -> {xb.tolist()} (non-finite, as on the TPU)")

    times = {}
    for F in (10_000, 1250, 40, 1):
        A, g, lam = _systems(F, 37, gen, device)
        acc = {"kernel": [], "plain": []}
        for name in ("plain", "kernel", "kernel", "plain"):
            fn = spd.spd_solve_cuda if name == "kernel" else spd.spd_solve_plain
            for _ in range(3):
                fn(A, g, lam)
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            reps = 50
            e0.record()
            for _ in range(reps):
                fn(A, g, lam)
            e1.record()
            torch.cuda.synchronize()
            acc[name].append(e0.elapsed_time(e1) / reps)
        times[F] = {k: sum(v) / len(v) for k, v in acc.items()}
        print(f"kernel time n=37 F={F:5d}: kernel {times[F]['kernel']:.4f} ms, "
              f"plain (cholesky_ex + cholesky_solve) {times[F]['plain']:.4f} ms")
    return {"max_abs_err": main_err, "worst_rel_err": worst, "times": times}


def phase_main(spd, device, bundle) -> dict:
    from stac_mjx_tpu_torch.models.firstparty import make_recording
    from stac_mjx_tpu_torch.stac import Stac

    stac_cfg = dict(THROUGHPUT, n_fit_frames=N_FIT, n_frames_per_clip=CLIP)
    (kp, _, true_off, _), rec_s = _sync_time(
        lambda: make_recording(bundle, n_frames=N_IK, seed=0, device=device)
    )
    print(f"main: recording {tuple(kp.shape)} made on the card in {rec_s:.3f} s")
    stac = Stac(bundle, stac_cfg, device=device)
    # Warm-up at a small size (CUDA context, cuBLAS handles, allocator).
    warm = Stac(bundle, dict(stac_cfg, n_frames_per_clip=16), model={"N_ITERS": 1}, device=device)
    warm.ik_only(kp[:32], warm.fit_offsets(kp[:16]).offsets)

    spd.KERNEL_LAUNCHES = 0
    fit, fit_s = _sync_time(lambda: stac.fit_offsets(kp[:N_FIT]))
    fit_launches = spd.KERNEL_LAUNCHES
    ik, ik_s = _sync_time(lambda: stac.ik_only(kp, fit.offsets))
    ik_launches = spd.KERNEL_LAUNCHES - fit_launches
    kp_host = kp.cpu().numpy()

    fit_resid = _resid(fit.marker_sites, fit.kp_data, N_FIT)
    _, _, ik_markers = stac.compute_full_outputs(ik.qpos)
    ik_resid = _resid(ik_markers, kp_host, N_IK)
    off_err = float(np.abs(fit.offsets - true_off).mean())
    print(f"main: fit {N_FIT} frames in {fit_s:.3f} s ({N_FIT / fit_s:.1f} frames/s), "
          f"mean marker residual {fit_resid * 1e3:.4f} mm, kernel launches {fit_launches}")
    print(f"main: ik {N_IK} frames ({N_IK // CLIP} clips of {CLIP}) in {ik_s:.3f} s "
          f"({N_IK / ik_s:.1f} frames/s), mean marker residual {ik_resid * 1e3:.4f} mm, "
          f"kernel launches {ik_launches}")
    print(f"main: offset error vs ground truth {off_err * 1e3:.4f} mm (mean abs over {fit.offsets.size} coords)")
    checks = {
        "fit launched the kernel": fit_launches > 0,
        "ik launched the kernel": ik_launches > 0,
        "qpos finite, right shapes": bool(
            np.isfinite(fit.qpos).all() and np.isfinite(ik.qpos).all()
            and fit.qpos.shape == (N_FIT, 44) and ik.qpos.shape == (N_IK, 44)
        ),
        f"fit residual < {FIT_RESID_MAX * 1e3} mm": fit_resid < FIT_RESID_MAX,
        f"ik residual < {IK_RESID_MAX * 1e3} mm": ik_resid < IK_RESID_MAX,
        f"offset error < {OFFSET_ERR_MAX * 1e3} mm": off_err < OFFSET_ERR_MAX,
    }
    for what, ok in checks.items():
        print(f"main: check {what}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise AssertionError("main path checks failed")
    return {"launches": fit_launches + ik_launches, "fit_s": fit_s, "ik_s": ik_s}


def phase_reference(device, bundle) -> None:
    """Small fit + hierarchical ik: the card (f32, CUDA kernel) against the
    CPU (f64, plain solve). Accept branches may flip between the two, so
    they are compared by quality: mean residuals within 2%."""
    from stac_mjx_tpu_torch.models.firstparty import make_recording
    from stac_mjx_tpu_torch.stac import Stac

    cfg = dict(THROUGHPUT, n_frames_per_clip=32, ik_hier_stride=4, ik_hier_fine_iters=3)
    kp, _, _, _ = make_recording(bundle, n_frames=64, seed=3)
    out = {}
    for where, dev, dt in (("card", device, torch.float32), ("cpu", "cpu", torch.float64)):
        st = Stac(bundle, cfg, model={"N_ITERS": 2}, device=dev, dtype=dt)
        fit = st.fit_offsets(kp[:40])
        ik = st.ik_only(kp, fit.offsets)
        _, _, markers = st.compute_full_outputs(ik.qpos)
        out[where] = (_resid(fit.marker_sites, fit.kp_data, 40), _resid(markers, kp.numpy(), 64))
    print(f"reference: fit/ik mean residual card {out['card'][0] * 1e3:.4f}/{out['card'][1] * 1e3:.4f} mm, "
          f"cpu f64 {out['cpu'][0] * 1e3:.4f}/{out['cpu'][1] * 1e3:.4f} mm")
    for a, b in zip(out["card"], out["cpu"]):
        if not abs(a - b) <= 0.02 * b:
            raise AssertionError(f"card and CPU reference disagree: {out}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    device = torch.device("cuda:0")

    sys.path.insert(0, str(ROOT))
    from stac_mjx_tpu_torch.bridge import load_bundle
    from stac_mjx_tpu_torch.ops import _build, spd

    t0 = time.perf_counter()
    spd._kernel()
    info = _build.BUILD_INFO["spd_chol"]
    regs = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln]
    print(f"build: spd_chol.cu in {time.perf_counter() - t0:.2f} s (nvcc {info['seconds']:.2f} s) {regs}")

    kern = phase_kernel(spd, device)
    bundle = load_bundle()
    main_run = phase_main(spd, device, bundle)
    phase_reference(device, bundle)

    t = kern["times"][10_000]
    print(json.dumps({"kernels": [{
        "name": "spd_chol_solve_f32",
        "route": "cuda",
        "source": "stac_mjx_tpu_torch/csrc/spd_chol.cu",
        "replaces": "stac_mjx_tpu/ops/spd.py:42",
        "launches": main_run["launches"],
        "max_abs_err": kern["max_abs_err"],
        "ms": t["kernel"],
        "plain_ms": t["plain"],
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
