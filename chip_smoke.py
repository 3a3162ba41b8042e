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
   the kernel's launch count must be 112 in the fit and 34 in the ik;
   residuals and the offset error against the ground truth must stay under
   stated bounds;
5. reference: a small fit + ik on the card against the same run on the CPU
   in float64 (the path the CPU tests hold against the JAX package);
6. parts: the main path with the per-part refinement passes on (the
   batched part schedule in the fit, 6 parts x 250 frames = 1,500 items;
   the part chain in the ik, 6 x 10,000 items being over the batched cap):
   launches must be exactly 210 and 118, residuals under the same bounds;
   then a small card-f32 against CPU-f64 run of that configuration;
7. K1 on part systems: A, g and lam captured from one iteration of the
   fit's batched part pass (masked dofs leave lam-only rows), the kernel
   against its plain version and a float64 solve;
8. kernel times: in turns, the kernel, the plain version and one library
   call (torch.linalg.solve) at the main path's shapes, as time per call on
   the stream (CUDA events) and as device time (torch.profiler), each
   beside its bound;
9. default: the JAX package's default configuration (sequential pose mode,
   projected gradient with autograd through the level-scan FK, the part
   chain, two root passes) through ``Stac(bundle, {"n_frames_per_clip":
   ...})``: the time and kernel launches per PG iteration, residuals, and
   the same run on the CPU in float64; then pg-jaxopt on the synth model
   from the synth golden's keypoints, against the golden;

Cuts, all of depth (the model keeps its full width, nq 44, nv 37, and the
solver settings, N_ITER_Q 400 and FTOL 1e-4, stay): the default phase fits
DEFAULT_FIT frames with N_ITERS 1 (the model's is 6) and runs the ik on
DEFAULT_CLIPS clips of DEFAULT_CLIP frames, so that it stays within
DEFAULT_BUDGET_S on the card: each PG iteration runs the scan FK forward and
backward (~2,400 small kernels) and the solves of a sequential pass follow
one another frame by frame; the reference phases run 40-64 frames with
N_ITERS 2.

The second-to-last line is {"kernels": [...]} and the last line
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
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
# K1 launches of the main path: the fit's root solve (14) and 7 pose passes
# of 14 LM iterations; the ik's root solve, coarse and fine passes (14 + 14
# + 6). The part passes add one 14-iteration solve per pose pass in the fit
# (batched) and 6 chained ones in the ik.
MAIN_LAUNCHES = (112, 34)
PARTS_LAUNCHES = (112 + 7 * 14, 34 + 6 * 14)
# The default phase's depth (see the cuts above) and its bounds: the card's
# mean residuals within 5% of the CPU's float64 run (PG stops on a
# tolerance, so float32 and float64 end at other iterates).
DEFAULT_FIT, DEFAULT_CLIPS, DEFAULT_CLIP = 5, 40, 5
DEFAULT_REL = 0.05
DEFAULT_BUDGET_S = 150.0


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
TIMED = [(37, F) for F in (10_000, 1500, 1250, 250, 40, 1)] + [(73, F) for F in (10_000, 1250, 40)]
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
        f"fit launched the kernel {MAIN_LAUNCHES[0]} times": fit_launches == MAIN_LAUNCHES[0],
        f"ik launched the kernel {MAIN_LAUNCHES[1]} times": ik_launches == MAIN_LAUNCHES[1],
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
    return {"launches": fit_launches + ik_launches, "fit_s": fit_s, "ik_s": ik_s, "kp": kp, "true_off": true_off}


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


@contextlib.contextmanager
def _one_cpu_thread():
    """The CPU float64 reference runs tiny tensors: intra-op threads only add
    synchronisation there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _check_all(phase: str, checks: dict) -> None:
    for what, ok in checks.items():
        print(f"{phase}: check {what}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise AssertionError(f"{phase} checks failed")


def phase_parts(spd, device, bundle, kp, true_off) -> dict:
    """The main path with the part passes on: the batched part schedule in
    the fit, the chain in the ik (its P x F items exceed the cap)."""
    from stac_mjx_tpu_torch import pipeline
    from stac_mjx_tpu_torch.models.firstparty import make_recording
    from stac_mjx_tpu_torch.stac import Stac

    cfg = dict(THROUGHPUT, skip_part_opt=False, n_fit_frames=N_FIT, n_frames_per_clip=CLIP)
    stac = Stac(bundle, cfg, device=device)
    P, cap = len(stac._static_cfg.indiv_parts), pipeline._PART_BATCH_MAX_ITEMS
    for what, items in (("fit", P * N_FIT), ("ik", P * N_IK)):
        schedule = "batched" if stac._static_cfg.part_opt_mode == "batched" and items <= cap else "chain"
        print(f"parts: {what} part schedule {schedule} ({P} parts x {items // P} frames = {items} items, cap {cap})")
    spd.KERNEL_LAUNCHES = 0
    fit, fit_s = _sync_time(lambda: stac.fit_offsets(kp[:N_FIT]))
    fit_launches = spd.KERNEL_LAUNCHES
    ik, ik_s = _sync_time(lambda: stac.ik_only(kp, fit.offsets))
    ik_launches = spd.KERNEL_LAUNCHES - fit_launches
    fit_resid = _resid(fit.marker_sites, fit.kp_data, N_FIT)
    _, _, ik_markers = stac.compute_full_outputs(ik.qpos)
    ik_resid = _resid(ik_markers, kp.cpu().numpy(), N_IK)
    off_err = float(np.abs(fit.offsets - true_off).mean())
    print(f"parts: fit {N_FIT} frames in {fit_s:.3f} s, mean marker residual {fit_resid * 1e3:.4f} mm, "
          f"kernel launches {fit_launches}")
    print(f"parts: ik {N_IK} frames in {ik_s:.3f} s ({N_IK / ik_s:.1f} frames/s), mean marker residual "
          f"{ik_resid * 1e3:.4f} mm, kernel launches {ik_launches}")
    print(f"parts: offset error vs ground truth {off_err * 1e3:.4f} mm")
    _check_all("parts", {
        f"fit launched the kernel {PARTS_LAUNCHES[0]} times": fit_launches == PARTS_LAUNCHES[0],
        f"ik launched the kernel {PARTS_LAUNCHES[1]} times": ik_launches == PARTS_LAUNCHES[1],
        "qpos finite": bool(np.isfinite(fit.qpos).all() and np.isfinite(ik.qpos).all()),
        f"fit residual < {FIT_RESID_MAX * 1e3} mm": fit_resid < FIT_RESID_MAX,
        f"ik residual < {IK_RESID_MAX * 1e3} mm": ik_resid < IK_RESID_MAX,
        f"offset error < {OFFSET_ERR_MAX * 1e3} mm": off_err < OFFSET_ERR_MAX,
    })
    # The same configuration small, card f32 against CPU f64, on phase
    # reference's recording (40 fit frames batch their 6 x 40 part items; the
    # 64 ik frames too).
    small = dict(cfg, n_frames_per_clip=32, ik_hier_stride=4, ik_hier_fine_iters=3)
    kp_s, _, _, _ = make_recording(bundle, n_frames=64, seed=3, device="cpu")
    out = {}
    for where, dev, dt in (("card", device, torch.float32), ("cpu", "cpu", torch.float64)):
        with _one_cpu_thread():
            st = Stac(bundle, small, model={"N_ITERS": 2}, device=dev, dtype=dt)
            f = st.fit_offsets(kp_s[:40])
            i = st.ik_only(kp_s, f.offsets)
            _, _, markers = st.compute_full_outputs(i.qpos)
        out[where] = (_resid(f.marker_sites, f.kp_data, 40), _resid(markers, kp_s.numpy(), 64))
    print(f"parts: small fit/ik mean residual card {out['card'][0] * 1e3:.4f}/{out['card'][1] * 1e3:.4f} mm, "
          f"cpu f64 {out['cpu'][0] * 1e3:.4f}/{out['cpu'][1] * 1e3:.4f} mm")
    _check_all("parts", {"small card and cpu f64 residuals within 2%":
                         all(abs(a - b) <= 0.02 * b for a, b in zip(out["card"], out["cpu"]))})
    return {"launches": fit_launches + ik_launches, "fit_s": fit_s, "ik_s": ik_s}


def phase_part_systems(spd, device, bundle, kp) -> None:
    """K1 on the systems of the fit's batched part pass: A, g and lam of one
    LM iteration, captured on the card, against the plain version and float64."""
    from stac_mjx_tpu_torch.ops import gn_ik
    from stac_mjx_tpu_torch.stac import Stac

    captured = []
    solve = gn_ik.spd_solve

    def capture(A, g, lam=None):
        if not captured and A.shape[0] == 6 * N_FIT and lam is not None:
            captured.append((A.clone(), g.clone(), lam.clone()))
        return solve(A, g, lam)

    cfg = dict(THROUGHPUT, skip_part_opt=False, n_frames_per_clip=CLIP)
    stac = Stac(bundle, cfg, model={"N_ITERS": 1}, device=device)
    gn_ik.spd_solve = capture
    try:
        stac.fit_offsets(kp[:N_FIT])
    finally:
        gn_ik.spd_solve = solve
    A, g, lam = captured[0]
    n = A.shape[-1]
    x = spd.spd_solve_cuda(A, g, lam)
    plain = spd.spd_solve_plain(A, g, lam)
    A64 = A.double() + lam.double()[:, None, None] * torch.eye(n, dtype=torch.float64, device=device)
    x64 = torch.linalg.solve(A64, g.double())
    torch.cuda.synchronize()
    lam_rows = int((A.abs().sum(-1) == 0).sum())
    err_plain = float((x - plain).abs().max() / plain.abs().max())
    err_f64 = float((x.double() - x64).abs().max() / x64.abs().max())
    print(f"part systems: A {tuple(A.shape)} from the fit's batched part pass, {lam_rows} lam-only rows; "
          f"kernel vs plain {err_plain:.3e}, vs f64 {err_f64:.3e} (bound {KERNEL_REL_TOL})")
    _check_all("part systems", {
        "kernel within bound of plain and f64": err_plain < KERNEL_REL_TOL and err_f64 < KERNEL_REL_TOL,
        "x finite": bool(torch.isfinite(x).all()),
    })


def _pg_iterations():
    """Counts the iterations of every PG solve (its slowest lane's) while active."""
    from stac_mjx_tpu_torch.ops import solver

    counts = {}
    run = solver.ProjectedGradient.run

    def counted(self, fun, x0, lb, ub):
        res = run(self, fun, x0, lb, ub)
        counts["iters"] += int(res.iters.max())
        counts["solves"] += 1
        return res

    @contextlib.contextmanager
    def active():
        counts.update(iters=0, solves=0)
        solver.ProjectedGradient.run = counted
        try:
            yield counts
        finally:
            solver.ProjectedGradient.run = run

    return active


def phase_default(device, bundle, kp) -> None:
    """The JAX package's default configuration: no solver keys."""
    from stac_mjx_tpu_torch.bridge import bundle_path, load_bundle
    from stac_mjx_tpu_torch.ops import solver
    from stac_mjx_tpu_torch.stac import Stac

    cfg = {"n_frames_per_clip": DEFAULT_CLIP}
    model = {"N_ITERS": 1}
    n_ik = DEFAULT_CLIPS * DEFAULT_CLIP
    counting = _pg_iterations()
    stac = Stac(bundle, cfg, model=model, device=device)
    sc = stac._static_cfg
    print(f"default: pose_mode {sc.pose_mode}, q_solver {stac.stac_core_obj.q_solver}, "
          f"fk {stac.stac_core_obj.fk_impl}, "
          f"{len(sc.indiv_parts)} parts ({sc.part_opt_mode}), {sc.root_opt_passes} root passes; "
          f"fit {DEFAULT_FIT} frames x N_ITERS 1, ik {DEFAULT_CLIPS} clips x {DEFAULT_CLIP} frames")
    t0 = time.perf_counter()
    with counting() as fit_n:
        fit, fit_s = _sync_time(lambda: stac.fit_offsets(kp[:DEFAULT_FIT]))
        fit_n = dict(fit_n)
    with counting() as ik_n:
        ik, ik_s = _sync_time(lambda: stac.ik_only(kp[:n_ik], fit.offsets))
        ik_n = dict(ik_n)
    wall = time.perf_counter() - t0
    _, _, ik_markers = stac.compute_full_outputs(ik.qpos)
    resid = (_resid(fit.marker_sites, fit.kp_data, DEFAULT_FIT), _resid(ik_markers, kp[:n_ik].cpu().numpy(), n_ik))
    for what, s_, n_ in (("fit", fit_s, fit_n), ("ik", ik_s, ik_n)):
        print(f"default: {what} in {s_:.3f} s, {n_['solves']} PG solves, {n_['iters']} PG iterations "
              f"(slowest lane), {1e3 * s_ / n_['iters']:.3f} ms per iteration")
    print(f"default: fit/ik mean marker residual {resid[0] * 1e3:.4f}/{resid[1] * 1e3:.4f} mm; "
          f"card wall {wall:.3f} s (budget {DEFAULT_BUDGET_S} s)")

    # Kernels and time per PG iteration: 20 iterations of the ik's full-q
    # solve shape (the clips on the lanes; tolerance 0, so all 20 run).
    core = stac.stac_core_obj
    q0 = stac.params.qpos0.expand(DEFAULT_CLIPS, -1).contiguous()
    kp_l = kp[:DEFAULT_CLIPS]
    qs = torch.ones(q0.shape[1], dtype=torch.bool, device=device)
    kps = torch.ones(kp_l.shape[1], device=device)
    pg = solver.ProjectedGradient(maxiter=20, tol=0.0)

    def twenty():
        return pg.run(lambda q: core.q_loss(q, stac.params, kp_l, qs, kps, q0), q0, stac._lb, stac._ub)

    twenty()
    _, t20 = _sync_time(twenty)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        twenty()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.end - e.time_range.start for e in kernels) * 1e-3
    print(f"default: PG over {DEFAULT_CLIPS} lanes from the rest pose: {1e3 * t20 / 20:.3f} ms per iteration "
          f"untraced (20 iterations, graph capture included); traced: {len(kernels) / 20:.1f} kernels and "
          f"{busy / 20:.3f} ms of device time per iteration")

    # The same run on the CPU in float64.
    with _one_cpu_thread():
        st64 = Stac(bundle, cfg, model=model, device="cpu", dtype=torch.float64)
        kp_c = kp[:n_ik].cpu()
        t0 = time.perf_counter()
        fit64 = st64.fit_offsets(kp_c[:DEFAULT_FIT])
        ik64 = st64.ik_only(kp_c, fit64.offsets)
        cpu_s = time.perf_counter() - t0
        _, _, ik64_markers = st64.compute_full_outputs(ik64.qpos)
    resid64 = (_resid(fit64.marker_sites, fit64.kp_data, DEFAULT_FIT), _resid(ik64_markers, kp_c.numpy(), n_ik))
    print(f"default: cpu f64 fit/ik mean marker residual {resid64[0] * 1e3:.4f}/{resid64[1] * 1e3:.4f} mm "
          f"in {cpu_s:.1f} s")

    # pg-jaxopt on the synth model from the synth golden's keypoints.
    golden = np.load(ROOT / "tests" / "goldens" / "synth.npz")
    synth = Stac(load_bundle(bundle_path("synth_data")), {"q_solver": "pg-jaxopt", "n_frames_per_clip": 1},
                 device=device)
    sfit = synth.fit_offsets(golden["fit_kp"])
    deltas = {k: float(np.abs(np.asarray(got) - golden[k]).max()) for k, got in
              (("fit_qpos", sfit.qpos), ("fit_offsets", sfit.offsets), ("fit_markers", sfit.marker_sites))}
    print("default: synth pg-jaxopt fit vs golden, max |delta|: "
          + ", ".join(f"{k} {v:.3e}" for k, v in deltas.items()))
    _check_all("default", {
        "qpos finite, right shapes": bool(np.isfinite(fit.qpos).all() and np.isfinite(ik.qpos).all()
                                          and fit.qpos.shape == (DEFAULT_FIT, 44) and ik.qpos.shape == (n_ik, 44)),
        f"fit and ik residual < {FIT_RESID_MAX * 1e3} mm": max(resid) < FIT_RESID_MAX,
        f"card and cpu f64 residuals within {DEFAULT_REL:.0%}":
            all(abs(a - b) <= DEFAULT_REL * b for a, b in zip(resid, resid64)),
        f"card wall within {DEFAULT_BUDGET_S} s": wall <= DEFAULT_BUDGET_S,
        "synth fit finite": bool(np.isfinite(sfit.qpos).all()),
    })


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
    parts = phase_parts(spd, device, bundle, main_run["kp"], main_run["true_off"])
    phase_part_systems(spd, device, bundle, main_run["kp"])
    times = phase_kernel_times(spd, device)
    phase_default(device, bundle, main_run["kp"])

    # launches: the main path's and the part passes' runs. ms, plain_ms and
    # library_ms: time per call on the stream, as since the first version of
    # this line; the *device_ms keys: torch.profiler device time.
    t = times[(37, 10_000)]
    print(json.dumps({"kernels": [{
        "name": "spd_chol_solve_f32",
        "route": "cuda",
        "source": "stac_mjx_tpu_torch/csrc/spd_chol.cu",
        "replaces": "stac_mjx_tpu/ops/spd.py:42",
        "launches": main_run["launches"] + parts["launches"],
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
