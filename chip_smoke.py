#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100), from a checkout.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. device: needs CUDA; prints the card's name and power limit (nvidia-smi);
2. build: compiles csrc/spd_chol.cu with nvcc (the batched-Cholesky kernel);
3. kernel: prints ptxas' registers and spills per kernel instantiation;
   holds the CUDA kernel against its plain PyTorch version and a float64
   solve at the edges of its register layout (n) and of its blocks (F), with
   and without lam; checks that one indefinite system poisons only its own
   x;
4. main path: the bench's throughput configuration (lockstep flat LM,
   pointer-doubling FK, no part passes, hierarchical ik 8/6) on the
   first-party model: a 10,000-frame recording made on the card, the fit on
   its first 250 frames, then ik on all 10,000 frames in 40 clips of 250;
   the kernel's launch count must rise in both; residuals and the offset
   error against the ground truth must stay under stated bounds;
5. reference: a small fit + ik on the card against the same run on the CPU
   in float64 (the path the CPU tests hold against the JAX package);
6. kernel times: in turns, the kernel, the plain version and one library
   call (torch.linalg.solve) at the main path's shapes, as time per call on
   the stream (CUDA events) and as device time (torch.profiler), each
   beside its bound.

The second-to-last line is {"kernels": [...]} and the last line
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import re
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
# The same run's residuals and offset error with the first version of the
# kernel (one block per system) on an H100: a kernel that changes only the
# float32 rounding keeps each within 2%.
FIRST_KERNEL_MM = {"fit residual": 2.1502, "ik residual": 1.4900, "offset error": 2.3203}
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


# The kernel phase: correctness at the register-layout edges of the kernel
# (a row block is 32 rows; 6, 37 and 73 are the models' sizes; the kernel's
# own max_n is added) and at batch sizes that are not a multiple of its four
# systems per block; times at the main path's shapes (PERF.md: n=37 at
# F=10,000 / 1,250 ik passes, 250 fit passes, 40 root batch, 1 flat LM) and
# at the rodent's n=73.
EDGE_N = (1, 6, 31, 32, 33, 37, 64, 65, 73)
EDGE_F = (1, 3, 40, 250, 1250, 10_000, 10_001)
TIMED = [(37, F) for F in (10_000, 1250, 250, 40, 1)] + [(73, F) for F in (10_000, 1250, 40)]
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and fp32 FLOP/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def _bound(F, n) -> tuple[float, str]:
    """Least time (ms) for F damped solves of size n, and what bounds it:
    the lower triangle of A, g and lam read once and x written once, against
    n^3/3 + 2n^2 flops per system."""
    nbytes = F * 4 * (n * (n + 1) // 2 + 2 * n + 1)
    flops = F * (n**3 / 3 + 2 * n**2)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _device_ms(fn, reps: int) -> float:
    """Device time per call: the sum of the call's kernel and copy durations
    (torch.profiler, CUPTI), free of the host's launch overhead."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us * 1e-3 / reps


def _stream_ms(fn, reps: int) -> float:
    """Time per call of back-to-back calls on the stream (CUDA events): the
    device time, or the host's dispatch time where that is longer."""
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _ptxas_summary(log: str) -> list[str]:
    """One entry per kernel instantiation (N): registers, spills, stack."""
    out, name = [], None
    for ln in log.splitlines():
        m = re.search(r"ILi(\d+)E", ln)  # spd_chol_warp_kernel<N>
        if "Compiling entry function" in ln and m:
            name = f"N={m[1]}"
        elif name and "spill" in ln:
            stack = ln.strip().split(" bytes stack frame")[0]
            spills = ln.split(",")[1].strip().split(" ")[0] + "/" + ln.split(",")[2].strip().split(" ")[0]
        elif name and "Used" in ln:
            regs = ln.split("Used ")[1].split(" ")[0]
            out.append(f"{name}: {regs} regs, spill st/ld {spills} B, stack {stack} B")
            name = None
    return out


def phase_kernel(spd, device) -> dict:
    """The kernel against its plain version and float64; NaN isolation."""
    from _torch_spd_cases import indefinite_batch, spd_systems

    max_n = spd._kernel()[1]
    gen = torch.Generator(device=device).manual_seed(0)
    worst = {"plain": 0.0, "f64": 0.0}
    main_err = None
    for n in EDGE_N + (max_n,):
        eye = torch.eye(n, device=device, dtype=torch.float64)
        for F in EDGE_F:
            A, g, lam = spd_systems(F, n, gen, device)
            for lam_ in (None, lam):
                x = spd.spd_solve(A, g, lam_)
                plain = spd.spd_solve_plain(A, g, lam_)
                A64 = A.double() + (0 if lam_ is None else lam_.double()[:, None, None] * eye)
                x64 = torch.linalg.solve(A64, g.double())
                torch.cuda.synchronize()
                err_plain = float((x - plain).abs().max() / plain.abs().max())
                err_f64 = float((x.double() - x64).abs().max() / x64.abs().max())
                if not (err_plain < KERNEL_REL_TOL and err_f64 < KERNEL_REL_TOL):
                    raise AssertionError(f"kernel disagrees at n={n} F={F} lam={lam_ is not None}: "
                                         f"{err_plain:.3e} vs plain, {err_f64:.3e} vs f64 (bound {KERNEL_REL_TOL})")
                worst["plain"] = max(worst["plain"], err_plain)
                worst["f64"] = max(worst["f64"], err_f64)
                if (n, F) == (37, 10_000) and lam_ is not None:
                    main_err = float((x - plain).abs().max())
            del A, g, lam
        print(f"kernel n={n:2d}: F in {EDGE_F}, lam and none: ok")
    print(f"kernel: worst rel err vs plain {worst['plain']:.3e}, vs f64 {worst['f64']:.3e} "
          f"over n in {EDGE_N + (max_n,)} (bound {KERNEL_REL_TOL})")

    for n in (6, 37, 73):
        A, g, mid = indefinite_batch(9, n, seed=n)
        A, g = (torch.as_tensor(a, dtype=torch.float32, device=device) for a in (A, g))
        fin = torch.isfinite(spd.spd_solve(A, g)).all(dim=1).tolist()
        if fin != [f != mid for f in range(9)]:
            raise AssertionError(f"indefinite system {mid} of 9 (n={n}): finite per system {fin}")
        print(f"kernel: n={n} batch of 9, system {mid} indefinite at column {n // 2}: only its x is non-finite")

    return {"max_abs_err": main_err}


def phase_kernel_times(spd, device) -> dict:
    """Kernel, plain version and library call in turns at each timed shape:
    time per call on the stream for every shape first, then device time, so
    that no profiler session precedes the stream timing."""
    from _torch_spd_cases import spd_systems

    gen = torch.Generator(device=device).manual_seed(1)
    cases = {}
    for n, F in TIMED:
        A, g, lam = spd_systems(F, n, gen, device)
        A_lam = A + lam[:, None, None] * torch.eye(n, device=device)  # outside the timed window
        cases[(n, F)] = {
            "kernel": lambda A=A, g=g, lam=lam: spd.spd_solve_cuda(A, g, lam),
            "plain": lambda A=A, g=g, lam=lam: spd.spd_solve_plain(A, g, lam),
            "library": lambda A_lam=A_lam, g=g: torch.linalg.solve(A_lam, g),
        }
    reps = 20
    times = {}
    for how, timer in (("stream", _stream_ms), ("device", _device_ms)):
        for key, fns in cases.items():
            acc = {k: [] for k in fns}
            for name in ("kernel", "plain", "library", "library", "plain", "kernel"):
                for _ in range(3):
                    fns[name]()
                torch.cuda.synchronize()
                acc[name].append(timer(fns[name], reps))
            for name, v in acc.items():
                times.setdefault(key, {}).setdefault(name, {})[how] = sum(v) / len(v)
    for (n, F), t in times.items():
        bound_ms, bound_by = _bound(F, n)
        t["bound_ms"], t["bound_by"] = bound_ms, bound_by
        print(f"kernel time n={n} F={F:5d}, ms per call on the stream (device ms): "
              f"kernel {t['kernel']['stream']:.4f} ({t['kernel']['device']:.4f}), "
              f"plain {t['plain']['stream']:.4f} ({t['plain']['device']:.4f}), "
              f"torch.linalg.solve {t['library']['stream']:.4f} ({t['library']['device']:.4f}); "
              f"bound {bound_ms:.4f} ms ({bound_by}), kernel device time at "
              f"{100 * bound_ms / t['kernel']['device']:.1f}% of it")
    return times


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
    for what, got in (("fit residual", fit_resid), ("ik residual", ik_resid), ("offset error", off_err)):
        ref = FIRST_KERNEL_MM[what]
        checks[f"{what} within 2% of {ref} mm"] = abs(got * 1e3 - ref) <= 0.02 * ref
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
    kp, _, _, _ = make_recording(bundle, n_frames=64, seed=3, device="cpu")
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
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]  # the port; the SPD test cases
    from stac_mjx_tpu_torch.bridge import load_bundle
    from stac_mjx_tpu_torch.ops import _build, spd

    # Everything runs on cuda:0; nvidia-smi is asked for that card by its UUID
    # (nvidia-smi's indices follow the PCI order, CUDA's need not).
    uuid = str(torch.cuda.get_device_properties(0).uuid)
    smi = subprocess.run(
        ["nvidia-smi", "-i", uuid if uuid.startswith("GPU-") else f"GPU-{uuid}",
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    device = torch.device("cuda:0")

    t0 = time.perf_counter()
    spd._kernel()
    info = _build.BUILD_INFO["spd_chol"]
    print(f"build: spd_chol.cu in {time.perf_counter() - t0:.2f} s (nvcc {info['seconds']:.2f} s)")
    for ln in _ptxas_summary(info["log"]):
        print(f"build: ptxas {ln}")

    kern = phase_kernel(spd, device)
    bundle = load_bundle()
    main_run = phase_main(spd, device, bundle)
    phase_reference(device, bundle)
    times = phase_kernel_times(spd, device)

    # ms, plain_ms and library_ms: time per call on the stream, as since the
    # first version of this line; the *device_ms keys: torch.profiler device time.
    t = times[(37, 10_000)]
    print(json.dumps({"kernels": [{
        "name": "spd_chol_solve_f32",
        "route": "cuda",
        "source": "stac_mjx_tpu_torch/csrc/spd_chol.cu",
        "replaces": "stac_mjx_tpu/ops/spd.py:42",
        "launches": main_run["launches"],
        "max_abs_err": kern["max_abs_err"],
        "ms": t["kernel"]["stream"],
        "plain_ms": t["plain"]["stream"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": t["library"]["stream"],
        "device_ms": t["kernel"]["device"],
        "plain_device_ms": t["plain"]["device"],
        "library_device_ms": t["library"]["device"],
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
