#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100), from a checkout.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. device: needs CUDA; prints the card's name and power limit (nvidia-smi);
2. build: compiles csrc/spd_chol.cu with nvcc (the batched-Cholesky kernel);
3. kernel: prints ptxas' registers and spills per kernel instantiation;
   holds the CUDA kernel against its plain PyTorch version and a float64
   solve at the edges of its register layout (n) and of its blocks (F), with
   and without lam, and at the tethered fly's shapes (n = 102, F = 22,800
   and 180,000); checks that one indefinite system poisons only its own
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
   call (torch.linalg.solve) at the main path's shapes and the fly's, as time per call on
   the stream (CUDA events) and as device time (torch.profiler), each
   beside its bound;
9. default: the JAX package's default configuration (sequential pose mode,
   projected gradient with autograd through the level-scan FK, the part
   chain, two root passes) through ``Stac(bundle, {"n_frames_per_clip":
   ...})``: the time and kernel launches per PG iteration, residuals, and
   the same run on the CPU in float64; then pg-jaxopt on the synth model
   from the synth golden's keypoints, against the golden;
10. driver: ``main.run_stac`` on the card, the main path's configuration
   with the continuous crossfade, qvel inference and the full payload: the
   config from the bundle's recorded model config (``config_from_dict``, no
   YAML files), the main phase's recording written as a DANNCE .mat and read
   by ``load_data``, the fit on 250 frames, its artifact read back by the ik
   (the resume contract; h5 files where h5py and PyYAML import, else an
   in-memory store in their place), continuous ik on 10,000 frames with
   qvel. Launches must be exactly 112 and 34; residuals and offset error
   under the bounds and within 2% of the main phase's; the card's float32
   qvel against the CPU's float64 on the artifact's qpos; wall times of the
   driver's steps;
11. distributed: ``parallel.distributed.run_stac_distributed`` on the main
   path's configuration (fit 250, ik 10,000 in 40 clips, the main phase's
   recording through a DANNCE .mat), in rank processes started as torchrun
   would start them (this script with ``--dist-worker``): one rank over
   NCCL, whose K1 launches must be exactly 112 and 34, its residuals and
   offset error the main phase's to the last printed digit and its qpos
   within 1e-6 of the main phase's; and, at the same time, two ranks on the
   one card over gloo with CUDA tensors (NCCL refuses two ranks on one
   device): both ranks' gathered outputs bitwise equal, fit residual and
   offset error under the bounds and within 2% of the main phase's (the
   sharded m-phase samples other frames by design), and an ik of each
   rank's 20 clips at the main phase's offsets within 1e-6 of the main
   phase's ik; K1 against its plain version on a rank's fit systems
   (F = 125);
12. options: the main configuration with gn_stall_iters=3 (K1 launches at
   most 112 and 34, residuals within 2% of the main phase's), with
   wire_dtype=float16 (the residual of the markers recomputed from the
   upcast qpos within 2e-4 m of the main phase's, fit and ik), the ik in
   chunks of 8 clips against one batch (qpos bitwise equal; both walls, in
   turns; K1 against its plain version on a chunk's fine-pass systems,
   F = 2,000), in chunks of 4 and 5 clips, and in chunks of 1 and 2 clips on
   the first 10 clips only (qpos bitwise equal to one batch of 40; 34
   launches per chunk) and the sequential gn-lm ik on 40 clips of 6 frames
   in one call (K1 launches 112; K1 against its plain version on the flat
   LM's lanes, F = 40);
13. profiling: ``utils.profiling.device_trace`` around one main-path ik;
   ``op_table`` must list K1's kernel with 34 launches and ``report()``
   must hold ``ik_only``;
14. model: ``run_stac`` on the main path's configuration (full payload)
   over phase 10's recording, artifacts in memory: (a) on firstparty's model
   config with ROOT_OPTIMIZATION_KEYPOINT TorsoF and one entry dropped from
   TRUNK_OPTIMIZATION_KEYPOINTS and INDIVIDUAL_PART_OPTIMIZATION, which the
   checked-in bundle serves with the set-up computed by the Stac (launches
   112 and 34, residuals and offset error under the bounds; the recorded
   config's set-up equals the bundle's stored arrays; a config without the
   root keypoint, the parts and the regularised sites gets none of them);
   (b) where mujoco imports (else one line says why not): firstparty
   compiled by the port's builder, equal to the checked-in bundle (bitwise
   under the mujoco release that wrote it, else to 1e-12), ``run_stac`` on
   it equal to phase 10 bitwise, then a config no bundle serves (every
   initial offset moved by a seeded +-3 mm), compiled and run: launches 112
   and 34, residuals and offset error under the bounds;
15. surface: ``kinematics.subtree_com`` over the main phase's 10,000 ik
   frames (body frames from the main Stac's FK at the fit's offsets, masses
   from ``assets/firstparty_inertia.npz``) against the same function on the
   CPU in float64, its time and its kernels per call (torch.profiler, 20
   calls); ``make_site_fk`` bitwise against the level-scan
   FK's site rows; the synth demo (``demos/torch_synth_data_demo.py``) on
   the card, lockstep with the linesearch GN: its residual, and its K1
   launches equal to its GN iterations plus linesearch retries, K1 against
   its plain version on a pose pass's systems; the graph-error demo's
   ``recompute_errors`` on phase 10's ik artifact against the CPU in
   float64; ``firstparty.write_assets`` byte-equal to the checked-in files.
   The phase's wall and the script's are printed on lines of their own;
16. fk: the FK kernel (``csrc/fk_jump.cu``): ptxas' registers and spills,
   then at the cells' shapes (the fly at F = 22,800 and 180,000, the critter
   at 23,040 and 180,000) and the main path's ik shapes (1,280 and 10,000;
   float32, seeded poses around qpos0) the kernel against the plain body
   (every output within FK_REL of the model's length scale), and in turns
   the kernel and the plain body timed on the stream and by device time
   (torch.profiler) beside the kernel's bound (bytes: qpos read once, the
   five outputs written once). It runs right after phase 7: later in the
   script torch.profiler records less and less of the card's activity
   (phase 15's tracing sees ~87% of its launches, and right after phase 15
   it saw none; a fresh process records with the card full and after
   phase 17 alike);
17. fly: the tethered fly (``assets/fly_tethered_bundle.npz``, nv 102) at
   the benchmark cell's size through ``Stac.ik_only`` as the benchmark's
   ``ik_fixed`` job runs it (one fixed session, 180,000 frames, every pass
   eager): the wide kernel's launches must be exactly 20 at width 104 (14
   coarse, 6 fine) and the FK kernel's 23 (15 coarse, 8 fine and outputs),
   the poses within the cell's limits by the float64 reference, K1 on the
   coarse pass's systems against its plain version and float64.

Every path clears the port's launch counter (``utils.profiling.LAUNCHES``)
before its run and reads K1's and the FK kernel's launches from it; the FK
kernel's launches must be MAIN_FK_LAUNCHES on the main path and
FK_LAUNCHES_BY_PATH on the others.

Cuts, all of depth (the model keeps its full width, nq 44, nv 37, and the
solver settings, N_ITER_Q 400 and FTOL 1e-4, stay): the default phase fits
DEFAULT_FIT frames with N_ITERS 1 (the model's is 6) and runs the ik on
DEFAULT_CLIPS clips of DEFAULT_CLIP frames, so that it stays within
DEFAULT_BUDGET_S on the card: each PG iteration runs the scan FK forward and
backward (~2,400 small kernels) and the solves of a sequential pass follow
one another frame by frame; the reference phases run 40-64 frames with
N_ITERS 2.

The second-to-last line is {"kernels": [...]} (the kernel at n = 37, its
layout past n = 96 at the fly's n = 102, and the FK kernel at the fly's
F = 180,000 with every timed shape) and the last line
{"ok": true, "device": {...}}. Imports nothing of JAX.

``python3 chip_smoke.py --dist-worker <spec.json>`` is one rank of phase 11;
phase 11 starts it, with torchrun's environment.
"""

from __future__ import annotations

import contextlib
import copy
import importlib
import importlib.util
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
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
# FK kernel launches (csrc/fk_jump.cu), read as K1's are. The main path's
# fit: 1 + 14 a solve over its 8 solves, and 13 passes for the m-phase and
# the outputs; its ik: 1 + 14 (root), 1 + 14 (coarse), 1 + 6 (fine) and the
# outputs pass. Every path whose K1 count is exact has an exact FK count
# (phase 17's fly: 15 in the coarse pass, 8 in the fine pass and the
# outputs); a run_stac of the main configuration launches what the main
# path does (phase 14 makes 1 such run, 3 where mujoco imports); the stall
# path launches at most that; the sequential ik 1 + 14 a solve over its 8
# solves and the outputs pass.
MAIN_FK_LAUNCHES = (133, 38)
FK_LAUNCHES_BY_PATH = {"main": 171, "parts": 366, "driver": 171, "distributed_1": 171,
                       "distributed_2": 2 * 171 + 2 * 38, "wire16": 171, "chunked": 1710, "sequential": 121,
                       "profiling": 38, "demo": 0, "fly": 23}
# The default phase's depth (see the cuts above) and its bounds: the card's
# mean residuals within 5% of the CPU's float64 run (PG stops on a
# tolerance, so float32 and float64 end at other iterates).
DEFAULT_FIT, DEFAULT_CLIPS, DEFAULT_CLIP = 5, 40, 5
DEFAULT_REL = 0.05
DEFAULT_BUDGET_S = 150.0
# The driver phase: run_stac on the main path's configuration with the
# continuous crossfade (windows of CLIP + 10 frames), qvel inference and the
# full payload. Its qvel (float32, on the card) is held against the same
# function on the CPU in float64 on the artifact's qpos: translation and
# joint columns to DRIVER_QVEL_REL relative; gyro columns to DRIVER_GYRO_ABS
# = 2 sqrt(2 * 2^-23) / dt = 0.488 rad/s on the frames where the card's
# float32 w of the normalised quaternion difference rounds to 1 (it comes
# out within 2 ulps of its exact value; there the card returns the zero
# rotation, float64 ~2|v| with |v| = sqrt(2 (1 - w)); see
# tests/test_torch_velocity.py), DRIVER_GYRO_REST_ABS elsewhere.
DRIVER = dict(THROUGHPUT, continuous=True, infer_qvels=True, ik_return_full=True)
DRIVER_QVEL_REL = 1e-3
DRIVER_GYRO_ABS = 0.49
# Off those frames: the rounding of v in float32 quaternion products, a few
# 2^-24, times 2 / dt, ~1e-4 rad/s; bounded at 1e-2.
DRIVER_GYRO_REST_ABS = 1e-2


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
# (a row block is 32 rows; 6, 37, 73 and 102 are the models' sizes; 96 is
# the last with every row in registers, 97 the first with rows in shared
# memory; the kernel's own max_n is added) and at batch sizes that are not a
# multiple of its four systems per block; times at the main path's shapes
# (PERF.md: n=37 at F=10,000 / 1,250 ik passes, 250 fit passes, 40 root
# batch, 1 flat LM), at the rodent's n=73 and at the tethered fly's n=102
# (its ik's coarse and fine passes, F=22,800 and 180,000), where the kernel is
# also held against its plain version.
EDGE_N = (1, 6, 31, 32, 33, 37, 64, 65, 73, 96, 97, 102)
EDGE_F = (1, 3, 40, 250, 1250, 10_000, 10_001)
FLY_SHAPES = ((102, 22_800), (102, 180_000))
F64_SAMPLE = 3000  # systems of a fly shape solved in float64, spread over the batch
TIMED = [(37, F) for F in (10_000, 1500, 1250, 250, 40, 1)] + [(73, F) for F in (10_000, 1250, 40)] + list(FLY_SHAPES)
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


def _device_kernels(fn, reps: int) -> dict[str, list[float]]:
    """{kernel or copy name: [launches, device us]} per call of back-to-back
    calls (torch.profiler, CUPTI), longest first."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per_call: dict[str, list[float]] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            row = per_call.setdefault(e.name, [0.0, 0.0])
            row[0] += 1 / reps
            row[1] += (e.time_range.end - e.time_range.start) / reps
    return dict(sorted(per_call.items(), key=lambda kv: -kv[1][1]))


def _device_ms(fn, reps: int) -> float:
    """Device time per call: the sum of the call's kernel and copy durations
    (torch.profiler, CUPTI), free of the host's launch overhead."""
    return sum(us for _, us in _device_kernels(fn, reps).values()) * 1e-3


def _launches():
    """The port's count of its hand-written kernels' launches
    (``utils.profiling.LAUNCHES``: ``"spd_chol"`` for K1, ``"fk_jump"`` for
    the FK kernel), which every path clears before its run."""
    from stac_mjx_tpu_torch.utils.profiling import LAUNCHES

    return LAUNCHES


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
    """One entry per kernel instantiation: registers, spills, stack;
    ``spd_chol_warp_kernel<N>`` as "N=...", the layout for n past 96
    (``spd_chol_wide_kernel<P3>``, P3 rows in shared memory) as "wide P3=..."."""
    out, name = [], None
    for ln in log.splitlines():
        m = re.search(r"ILi(\d+)E", ln)
        if "Compiling entry function" in ln and m:
            name = f"wide P3={m[1]}" if "wide_kernel" in ln else f"N={m[1]}"
        elif name and "spill" in ln:
            stack = ln.strip().split(" bytes stack frame")[0]
            spills = ln.split(",")[1].strip().split(" ")[0] + "/" + ln.split(",")[2].strip().split(" ")[0]
        elif name and "Used" in ln:
            regs = ln.split("Used ")[1].split(" ")[0]
            out.append(f"{name}: {regs} regs, spill st/ld {spills} B, stack {stack} B")
            name = None
    return out


def _kernel_errors(spd, A, g, lam, f64_rows=None) -> tuple[float, float, torch.Tensor, torch.Tensor]:
    """(max |x - plain| / max |plain|, max |x - x64| / max |x64|, x, plain): the
    kernel against its plain version on every system, and against a float64
    solve on the systems ``f64_rows`` (all of them by default)."""
    x = spd.spd_solve(A, g, lam)
    plain = spd.spd_solve_plain(A, g, lam)
    rows = slice(None) if f64_rows is None else f64_rows
    A64 = A[rows].double()
    if lam is not None:
        A64 = A64 + lam[rows].double()[:, None, None] * torch.eye(A.shape[-1], device=A.device, dtype=torch.float64)
    x64 = torch.linalg.solve(A64, g[rows].double())
    torch.cuda.synchronize()
    err_plain = float((x - plain).abs().max() / plain.abs().max())
    err_f64 = float((x[rows].double() - x64).abs().max() / x64.abs().max())
    return err_plain, err_f64, x, plain


def phase_kernel(spd, device) -> dict:
    """The kernel against its plain version and float64; NaN isolation."""
    from _torch_spd_cases import indefinite_batch, spd_systems

    max_n = spd._kernel()[1]
    gen = torch.Generator(device=device).manual_seed(0)
    worst = {"plain": 0.0, "f64": 0.0}
    main_err = None

    def held(n, F, lam_, err_plain, err_f64):
        if not (err_plain < KERNEL_REL_TOL and err_f64 < KERNEL_REL_TOL):
            raise AssertionError(f"kernel disagrees at n={n} F={F} lam={lam_ is not None}: "
                                 f"{err_plain:.3e} vs plain, {err_f64:.3e} vs f64 (bound {KERNEL_REL_TOL})")
        worst["plain"] = max(worst["plain"], err_plain)
        worst["f64"] = max(worst["f64"], err_f64)

    for n in EDGE_N + (max_n,):
        for F in EDGE_F:
            A, g, lam = spd_systems(F, n, gen, device)
            for lam_ in (None, lam):
                err_plain, err_f64, x, plain = _kernel_errors(spd, A, g, lam_)
                held(n, F, lam_, err_plain, err_f64)
                if (n, F) == (37, 10_000) and lam_ is not None:
                    main_err = float((x - plain).abs().max())
            del A, g, lam
        print(f"kernel n={n:2d}: F in {EDGE_F}, lam and none: ok")
    for n, F in FLY_SHAPES:  # every system against plain, F64_SAMPLE of them against float64
        A, g, lam = spd_systems(F, n, gen, device)
        rows = torch.arange(0, F, max(1, F // F64_SAMPLE), device=device)
        for lam_ in (None, lam):
            before = _launches()["spd_chol", spd.dispatch_width(n)]
            err_plain, err_f64, x, _ = _kernel_errors(spd, A, g, lam_, rows)
            held(n, F, lam_, err_plain, err_f64)
            if _launches()["spd_chol", spd.dispatch_width(n)] != before + 1 or not bool(torch.isfinite(x).all()):
                raise AssertionError(f"kernel at n={n} F={F}: not one launch at width {spd.dispatch_width(n)}, "
                                     f"or x not finite")
            print(f"kernel n={n} F={F} lam={lam_ is not None} (the fly's ik): vs plain {err_plain:.3e}, "
                  f"vs f64 {err_f64:.3e} on {len(rows)} systems")
        del A, g, lam, x
        torch.cuda.empty_cache()
    print(f"kernel: worst rel err vs plain {worst['plain']:.3e}, vs f64 {worst['f64']:.3e} "
          f"over n in {EDGE_N + (max_n,)} and the fly's shapes {FLY_SHAPES} (bound {KERNEL_REL_TOL})")

    for n in (6, 37, 73, 102):
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

    launched = _launches()
    launched.clear()
    fit, fit_s = _sync_time(lambda: stac.fit_offsets(kp[:N_FIT]))
    fit_launches, fit_fk = launched["spd_chol"], launched["fk_jump"]
    ik, ik_s = _sync_time(lambda: stac.ik_only(kp, fit.offsets))
    ik_launches, ik_fk = launched["spd_chol"] - fit_launches, launched["fk_jump"] - fit_fk
    kp_host = kp.cpu().numpy()

    fit_resid = _resid(fit.marker_sites, fit.kp_data, N_FIT)
    _, _, ik_markers = stac.compute_full_outputs(ik.qpos)
    ik_resid = _resid(ik_markers, kp_host, N_IK)
    off_err = float(np.abs(fit.offsets - true_off).mean())
    print(f"main: fit {N_FIT} frames in {fit_s:.3f} s ({N_FIT / fit_s:.1f} frames/s), "
          f"mean marker residual {fit_resid * 1e3:.4f} mm, kernel launches {fit_launches}, FK kernel {fit_fk}")
    print(f"main: ik {N_IK} frames ({N_IK // CLIP} clips of {CLIP}) in {ik_s:.3f} s "
          f"({N_IK / ik_s:.1f} frames/s), mean marker residual {ik_resid * 1e3:.4f} mm, "
          f"kernel launches {ik_launches}, FK kernel {ik_fk}")
    print(f"main: offset error vs ground truth {off_err * 1e3:.4f} mm (mean abs over {fit.offsets.size} coords)")
    checks = {
        f"fit launched the kernel {MAIN_LAUNCHES[0]} times": fit_launches == MAIN_LAUNCHES[0],
        f"ik launched the kernel {MAIN_LAUNCHES[1]} times": ik_launches == MAIN_LAUNCHES[1],
        f"fit and ik launched the FK kernel {MAIN_FK_LAUNCHES} times": (fit_fk, ik_fk) == MAIN_FK_LAUNCHES,
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
    return {"launches": fit_launches + ik_launches, "fk": fit_fk + ik_fk, "fit_s": fit_s, "ik_s": ik_s, "kp": kp,
            "true_off": true_off,
            "fit_resid": fit_resid, "ik_resid": ik_resid, "off_err": off_err, "fit": fit, "ik": ik, "stac": stac}


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
    launched = _launches()
    launched.clear()
    fit, fit_s = _sync_time(lambda: stac.fit_offsets(kp[:N_FIT]))
    fit_launches = launched["spd_chol"]
    ik, ik_s = _sync_time(lambda: stac.ik_only(kp, fit.offsets))
    ik_launches, fk = launched["spd_chol"] - fit_launches, launched["fk_jump"]
    fit_resid = _resid(fit.marker_sites, fit.kp_data, N_FIT)
    _, _, ik_markers = stac.compute_full_outputs(ik.qpos)
    ik_resid = _resid(ik_markers, kp.cpu().numpy(), N_IK)
    off_err = float(np.abs(fit.offsets - true_off).mean())
    print(f"parts: fit {N_FIT} frames in {fit_s:.3f} s, mean marker residual {fit_resid * 1e3:.4f} mm, "
          f"kernel launches {fit_launches}")
    print(f"parts: ik {N_IK} frames in {ik_s:.3f} s ({N_IK / ik_s:.1f} frames/s), mean marker residual "
          f"{ik_resid * 1e3:.4f} mm, kernel launches {ik_launches}; FK kernel launches in both {fk}")
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
    return {"launches": fit_launches + ik_launches, "fk": fk, "fit_s": fit_s, "ik_s": ik_s}


@contextlib.contextmanager
def _capturing(keep):
    """While active, the first SPD system (A, g, lam) that the solvers pass
    to the kernel's wrapper with keep(A, lam) true is cloned into the
    yielded list (the solve itself is unchanged)."""
    from stac_mjx_tpu_torch.ops import gn_ik

    captured = []
    solve = gn_ik.spd_solve

    def capture(A, g, lam=None):
        if not captured and keep(A, lam):
            captured.append((A.clone(), g.clone(), None if lam is None else lam.clone()))
        return solve(A, g, lam)

    gn_ik.spd_solve = capture
    try:
        yield captured
    finally:
        gn_ik.spd_solve = solve


def _kernel_vs_plain(spd, A, g, lam) -> tuple[float, float, bool]:
    """The kernel against its plain version and a float64 solve on captured
    systems: (max |dx| / max |x| vs plain, the same vs float64, x finite)."""
    err_plain, err_f64, x, _ = _kernel_errors(spd, A, g, lam)
    return err_plain, err_f64, bool(torch.isfinite(x).all())


def phase_part_systems(spd, device, bundle, kp) -> None:
    """K1 on the systems of the fit's batched part pass: A, g and lam of one
    LM iteration, captured on the card, against the plain version and float64."""
    from stac_mjx_tpu_torch.stac import Stac

    cfg = dict(THROUGHPUT, skip_part_opt=False, n_frames_per_clip=CLIP)
    stac = Stac(bundle, cfg, model={"N_ITERS": 1}, device=device)
    with _capturing(lambda A, lam: A.shape[0] == 6 * N_FIT and lam is not None) as captured:
        stac.fit_offsets(kp[:N_FIT])
    A, g, lam = captured[0]
    err_plain, err_f64, finite = _kernel_vs_plain(spd, A, g, lam)
    lam_rows = int((A.abs().sum(-1) == 0).sum())
    print(f"part systems: A {tuple(A.shape)} from the fit's batched part pass, {lam_rows} lam-only rows; "
          f"kernel vs plain {err_plain:.3e}, vs f64 {err_f64:.3e} (bound {KERNEL_REL_TOL})")
    _check_all("part systems", {
        "kernel within bound of plain and f64": err_plain < KERNEL_REL_TOL and err_f64 < KERNEL_REL_TOL,
        "x finite": finite,
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


def _importable(name: str) -> bool:
    try:
        importlib.import_module(name)
        return True
    except ImportError:
        return False


class _MemoryArtifacts:
    """Stands in for ``io.save_data_to_h5`` / ``io.load_stac_data`` where h5py
    or PyYAML is missing: the artifacts' config and arrays are kept in memory
    under their paths, so the resume contract (the ik reads the offsets and
    its config back from the fit's artifact) still round-trips through it.
    A double of the file I/O only: the solves run on the card either way."""

    def __init__(self, io):
        self.io, self.files = io, {}

    def save(self, config, file_path, **fields):
        self.files[str(file_path)] = (config.to_dict(), {k: copy.deepcopy(v) for k, v in fields.items()})

    def load(self, file_path):
        from stac_mjx_tpu_torch.config import config_from_dict

        cfg, fields = self.files[str(file_path)]
        return config_from_dict(copy.deepcopy(cfg)), self.io.StacData(**copy.deepcopy(fields))

    @contextlib.contextmanager
    def installed(self):
        saved = self.io.save_data_to_h5, self.io.load_stac_data
        self.io.save_data_to_h5, self.io.load_stac_data = self.save, self.load
        try:
            yield
        finally:
            self.io.save_data_to_h5, self.io.load_stac_data = saved


@contextlib.contextmanager
def _timed(owner, name: str, times: dict, after=None):
    """Wraps owner.name so that each call adds its wall time to times[name]
    (the wrapped functions end on the host, so the wall time holds the
    card's work); after(result), if given, runs after each call."""
    fn = getattr(owner, name)

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        times[name] = times.get(name, 0.0) + time.perf_counter() - t0
        if after is not None:
            after(out)
        return out

    setattr(owner, name, wrapper)
    try:
        yield
    finally:
        setattr(owner, name, fn)


def _write_mat(cfg, kp_host: np.ndarray, path: Path) -> np.ndarray:
    """The recording as a DANNCE .mat ("pred", (F, 3, K), mocap units); returns pred."""
    from scipy.io import savemat

    scale = float(cfg.model.MOCAP_SCALE_FACTOR)
    pred = np.transpose(kp_host.astype(np.float64).reshape(kp_host.shape[0], -1, 3) / scale, (0, 2, 1))
    savemat(path, {"pred": pred})
    return pred


def phase_driver(spd, device, bundle, main_run, smi: str) -> dict:
    """run_stac on the card: the config from the bundle's recorded model
    config, the recording through a DANNCE .mat and load_data, the fit's
    artifact read back by the ik (the resume contract), continuous ik with
    the crossfade and qvel; launches, residuals and qvel checked."""
    from stac_mjx_tpu_torch import io
    from stac_mjx_tpu_torch import main as driver
    from stac_mjx_tpu_torch.config import config_from_dict
    from stac_mjx_tpu_torch.stac import Stac
    from stac_mjx_tpu_torch.utils.velocity import compute_velocity_from_kinematics

    t_phase = time.perf_counter()
    missing = [m for m in ("h5py", "yaml") if not _importable(m)]
    if missing:
        print(f"driver: {' and '.join(missing)} not importable here; the artifacts go to an in-memory store "
              f"in place of h5 files (io.save_data_to_h5 / io.load_stac_data), the solves run on the card as ever")
    else:
        print("driver: h5py and PyYAML importable; the artifacts are h5 files, read back by io.load_stac_data")
    kp_card, true_off = main_run["kp"], main_run["true_off"]
    kp_host = kp_card.cpu().numpy()
    times, launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cfg = config_from_dict({"model": json.loads(str(bundle["model_config"])), "stac": dict(
            DRIVER, fit_offsets_path="fit.h5", ik_only_path="ik.h5", data_path="recording.mat",
            n_fit_frames=N_FIT, n_frames_per_clip=CLIP, skip_fit_offsets=False, skip_ik_only=False)})
        pred = _write_mat(cfg, kp_host, tmp / "recording.mat")
        kp_data, names = io.load_data(cfg, base_path=tmp)
        mat_err = float(np.abs(kp_data - kp_host).max())
        print(f"driver: recording {pred.shape} written as a DANNCE .mat (mocap units, x{1 / float(cfg.model.MOCAP_SCALE_FACTOR):g}) and "
              f"loaded back by load_data: {kp_data.shape} {kp_data.dtype}, max |change| {mat_err:.3e} m")

        launched = _launches()

        def fit_done(_):
            launches["fit"] = launched["spd_chol"]

        with contextlib.ExitStack() as stack:
            if missing:
                stack.enter_context(_MemoryArtifacts(io).installed())
            for owner, name, after in ((driver, "fit_phase", fit_done), (Stac, "ik_only", None),
                                       (driver, "infer_qvels", None), (io, "save_data_to_h5", None)):
                stack.enter_context(_timed(owner, name, times, after))
            launched.clear()
            (fit_path, ik_path), run_s = _sync_time(
                lambda: driver.run_stac(cfg, kp_data, names, base_path=tmp, device=device))
            launches["ik"], launches["fk"] = launched["spd_chol"] - launches["fit"], launched["fk_jump"]
            (_, fit), (ik_cfg, ik) = io.load_stac_data(fit_path), io.load_stac_data(ik_path)

    fit_resid = _resid(fit.marker_sites, fit.kp_data, N_FIT)
    ik_resid = _resid(ik.marker_sites, ik.kp_data, N_IK)
    off_err = float(np.abs(fit.offsets - true_off).mean())
    q64 = torch.as_tensor(ik.qpos, dtype=torch.float64).reshape(-1, CLIP, ik.qpos.shape[-1])
    with _one_cpu_thread():
        want = compute_velocity_from_kinematics(q64, dt=float(bundle["timestep"])).reshape(N_IK, -1).numpy()
    lin = np.r_[0:3, 6 : want.shape[1]]
    rel = float((np.abs(ik.qvel[:, lin] - want[:, lin]) / np.maximum(np.abs(want[:, lin]), 1e-30)).max())
    gyro = np.abs(ik.qvel[:, 3:6] - want[:, 3:6]).max(axis=1)
    # Frames where float32 w rounded to 1: the card's zero rotation against
    # float64's ~2|v|. Elsewhere the gyro is held to DRIVER_GYRO_REST_ABS.
    flips = (ik.qvel[:, 3:6] == 0).all(axis=1) & (want[:, 3:6] != 0).any(axis=1)
    rest = float(gyro[~flips].max(initial=0.0))
    print(f"driver: run_stac in {run_s:.3f} s ({smi}): fit_phase {times['fit_phase']:.3f} s (its write "
          f"included), ik solve {times['ik_only']:.3f} s, qvel {times['infer_qvels']:.4f} s, artifact writes "
          f"{times['save_data_to_h5']:.4f} s ({'in memory' if missing else 'h5'}); kernel launches "
          f"{launches['fit']} (fit) + {launches['ik']} (ik), FK kernel {launches['fk']}")
    print(f"driver: fit residual {fit_resid * 1e3:.4f} mm, offset error {off_err * 1e3:.4f} mm (main phase "
          f"{main_run['fit_resid'] * 1e3:.4f}, {main_run['off_err'] * 1e3:.4f} mm); ik residual from the "
          f"artifact's markers {ik_resid * 1e3:.4f} mm, {ik_resid / main_run['ik_resid']:.4f}x the main phase's "
          f"{main_run['ik_resid'] * 1e3:.4f} mm (the crossfade blends qpos and markers in the 10-frame overlaps)")
    print(f"driver: qvel {ik.qvel.shape} {ik.qvel.dtype}; card f32 vs cpu f64 on the artifact's qpos: "
          f"translation and joints max rel {rel:.3e} (bound {DRIVER_QVEL_REL}), gyro max abs {gyro.max():.3e} rad/s "
          f"(bound {DRIVER_GYRO_ABS}) in {int(flips.sum())} of {N_IK} frames where the card's float32 w rounded "
          f"to 1, {rest:.3e} rad/s in the others (bound {DRIVER_GYRO_REST_ABS}); phase wall "
          f"{time.perf_counter() - t_phase:.2f} s")
    _check_all("driver", {
        f"fit launched the kernel {MAIN_LAUNCHES[0]} times": launches["fit"] == MAIN_LAUNCHES[0],
        f"ik launched the kernel {MAIN_LAUNCHES[1]} times": launches["ik"] == MAIN_LAUNCHES[1],
        f"fit residual < {FIT_RESID_MAX * 1e3} mm, within 2% of the main phase's":
            fit_resid < FIT_RESID_MAX and abs(fit_resid - main_run["fit_resid"]) <= 0.02 * main_run["fit_resid"],
        f"offset error < {OFFSET_ERR_MAX * 1e3} mm, within 2% of the main phase's":
            off_err < OFFSET_ERR_MAX and abs(off_err - main_run["off_err"]) <= 0.02 * main_run["off_err"],
        f"ik residual < {IK_RESID_MAX * 1e3} mm": ik_resid < IK_RESID_MAX,
        "the ik artifact's config is the fit's": ik_cfg.to_dict() == cfg.to_dict(),
        "qpos (10000, 44), qvel (10000, 43), finite": ik.qpos.shape == (N_IK, 44) and ik.qvel.shape == (N_IK, 43)
            and bool(np.isfinite(ik.qpos).all() and np.isfinite(ik.qvel).all()),
        "qvel joint columns within +-20": bool(np.abs(ik.qvel[:, 6:]).max() <= 20.0),
        f"qvel translation and joints within {DRIVER_QVEL_REL} relative of cpu f64": rel <= DRIVER_QVEL_REL,
        f"qvel gyro within {DRIVER_GYRO_ABS} rad/s of cpu f64": bool(gyro.max() <= DRIVER_GYRO_ABS),
        f"qvel gyro within {DRIVER_GYRO_REST_ABS} rad/s where w < 1": rest <= DRIVER_GYRO_REST_ABS,
    })
    return {"launches": launches["fit"] + launches["ik"], "fk": launches["fk"], "conf": cfg.to_dict(), "fit": fit,
            "ik": ik}



# Phase 11: the main path's configuration through run_stac_distributed, in
# rank processes. DIST_TIMEOUT_S bounds each rank process.
DIST = dict(THROUGHPUT, skip_fit_offsets=False, skip_ik_only=False, infer_qvels=False)
DIST_TIMEOUT_S = 300
DIST_QPOS_ABS = 1e-6
# The two-rank fit: each rank warm-starts its pose passes from its own last
# frame (the JAX sharded fit's schedule), which lands closer to its frames
# than the one-rank carry does, and samples its own frames. Bound: no more
# than 2% above the main phase's fit residual and offset error.
DIST_REL = 0.02
# Clips are independent, and the flat LM rounds alike in any batch
# (``GNIK._gradient``): a rank's 20 clips or a chunk of 8 at the main
# phase's offsets end within DIST_QPOS_ABS of the main phase's ik.


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _start_ranks(tag: str, world: int, spec: dict, tmp: Path) -> list:
    """``world`` rank processes of this script (``--dist-worker``), with the
    environment torchrun gives its workers."""
    port = _free_port()
    procs = []
    for rank in range(world):
        spec_path = tmp / f"{tag}_rank{rank}.json"
        spec_path.write_text(json.dumps(dict(spec, out=str(tmp / f"{tag}_rank{rank}.npz"))))
        env = dict(os.environ, WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port))
        procs.append(subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--dist-worker", str(spec_path)],
                                      env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def _join_ranks(tag: str, procs: list, tmp: Path) -> list[dict]:
    """Waits for every rank (killing all of them on a timeout or a failure),
    prints each rank's lines, and returns each rank's saved arrays."""
    logs, failed = [], None
    for rank, proc in enumerate(procs):
        try:
            out, _ = proc.communicate(timeout=DIST_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            out, failed = "", f"rank {rank} timed out after {DIST_TIMEOUT_S} s"
        logs.append(out)
        if failed is None and proc.returncode != 0:
            failed = f"rank {rank} exited with {proc.returncode}"
        if failed:
            for other in procs:
                other.kill()
                other.communicate()
            break
    for rank, out in enumerate(logs):
        for ln in out.splitlines():
            if ln.startswith("dist-worker") or failed:
                print(f"{tag} rank {rank}: {ln}")
    if failed:
        raise AssertionError(f"{tag}: {failed}")
    return [dict(np.load(tmp / f"{tag}_rank{rank}.npz")) for rank in range(len(procs))]


def dist_worker(spec_path: str) -> int:
    """One rank of phase 11: run_stac_distributed on the card, then (with
    spec["ik_main_offsets"]) an ik of this rank's clips at the main phase's
    offsets; K1 against its plain version on the first captured system of
    spec["capture_F"] frames. Saves the rank's results to spec["out"]."""
    spec = json.loads(Path(spec_path).read_text())
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    import torch.distributed as dist

    from stac_mjx_tpu_torch import io
    from stac_mjx_tpu_torch import main as driver
    from stac_mjx_tpu_torch.config import config_from_dict
    from stac_mjx_tpu_torch.ops import spd
    from stac_mjx_tpu_torch.parallel.distributed import (
        init_distributed, local_clip_range, make_global_clips, pod_mesh, run_stac_distributed)
    from stac_mjx_tpu_torch.stac import Stac
    from stac_mjx_tpu_torch.utils.batching import batch_kp_data

    device = torch.device(spec["device"])
    init_distributed(backend=spec["backend"], device=device)  # torchrun's environment
    mesh = pod_mesh(device)
    cfg = config_from_dict(spec["config"])
    results, times, launches = {}, {}, {}
    launched = _launches()

    def keep(what):
        def after(out):
            results[what], launches[what] = out, launched["spd_chol"]
        return after

    missing = [m for m in ("h5py", "yaml") if not _importable(m)]
    capture_f = spec.get("capture_F", -1)
    with contextlib.ExitStack() as stack:
        if missing:
            stack.enter_context(_MemoryArtifacts(io).installed())
        stack.enter_context(_timed(Stac, "fit_offsets_sharded", times, keep("fit")))
        stack.enter_context(_timed(Stac, "ik_only_global", times, keep("ik")))
        captured = stack.enter_context(_capturing(lambda A, lam: A.shape[0] == capture_f and lam is not None))
        dist.barrier()
        launched.clear()
        _, run_s = _sync_time(lambda: run_stac_distributed(cfg, base_path=spec["dir"], mesh=mesh))
    fit, ik = results["fit"], results["ik"]
    out = {"fit_qpos": fit.qpos, "fit_offsets": fit.offsets, "fit_markers": fit.marker_sites,
           "fit_kp": fit.kp_data, "ik_qpos": ik.qpos, "ik_markers": ik.marker_sites, "ik_kp": ik.kp_data,
           "launches": np.array([launches["fit"], launches["ik"] - launches["fit"]]), "fk": np.array(launched["fk_jump"]),
           "walls": np.array([run_s, times["fit_offsets_sharded"], times["ik_only_global"]])}
    if spec.get("ik_main_offsets"):
        kp_data, names = io.load_data(cfg, base_path=spec["dir"])
        batched = batch_kp_data(np.asarray(kp_data, np.float32), CLIP)
        lo, hi = local_clip_range(batched.shape[0], mesh)
        stac = driver.make_stac(cfg, names, device=device)
        launched.clear()
        ik_main = stac.ik_only_global(make_global_clips(batched[lo:hi], mesh), np.load(spec["ik_main_offsets"]), mesh)
        out["ik_main_qpos"], out["ik_main_launches"] = ik_main.qpos, np.array(launched["spd_chol"])
        out["ik_main_fk"] = np.array(launched["fk_jump"])
    if captured:
        A, g, lam = captured[0]
        out["capture"] = np.array([A.shape[0], *_kernel_vs_plain(spd, A, g, lam)])
    np.savez(spec["out"], **out)
    print(f"dist-worker: {spec['backend']} rank {mesh.rank} of {mesh.size} on {device}: run_stac_distributed "
          f"{run_s:.3f} s (fit {times['fit_offsets_sharded']:.3f} s, ik {times['ik_only_global']:.3f} s), "
          f"K1 launches {out['launches'].tolist()}, FK kernel {int(out['fk'])}", flush=True)
    dist.destroy_process_group()
    return 0


def _fmt_mm(x: float) -> str:
    return f"{x * 1e3:.4f}"


def _ik_agreement(main_run, qpos: np.ndarray) -> dict:
    """An ik's qpos at the main phase's fit offsets against the main phase's
    ik: max |dqpos|, frames with any |dqpos| > DIST_QPOS_ABS, mean residuals
    (markers from both qpos by the main Stac's FK) and max |dmarker|."""
    stac, ref = main_run["stac"], main_run["ik"].qpos
    stac._offsets = main_run["fit"].offsets
    kp_host = main_run["kp"].cpu().numpy()
    _, _, markers = stac.compute_full_outputs(qpos)
    _, _, ref_markers = stac.compute_full_outputs(ref)
    dq = np.abs(qpos - ref)
    return {"dq": float(dq.max()), "frames": int((dq.max(axis=1) > DIST_QPOS_ABS).sum()),
            "resid": _resid(markers, kp_host, N_IK), "ref_resid": _resid(ref_markers, kp_host, N_IK),
            "dmarker": float(np.abs(markers - ref_markers).max())}


def _agreement_line(a: dict) -> str:
    return (f"max |qpos - main| {a['dq']:.3e} ({a['frames']} of {N_IK} frames above {DIST_QPOS_ABS}), max |marker - "
            f"main| {a['dmarker']:.3e} m, mean residual {_fmt_mm(a['resid'])} mm ({a['resid'] / a['ref_resid']:.6f}x "
            f"main)")



def phase_distributed(spd, device, bundle, main_run, smi: str) -> dict:
    """run_stac_distributed over one rank (NCCL) and, at the same time, two
    ranks on the one card (gloo, CUDA tensors), against the main phase."""
    from stac_mjx_tpu_torch.config import config_from_dict

    t_phase = time.perf_counter()
    fit0, ik0 = main_run["fit"], main_run["ik"]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        conf = {"model": json.loads(str(bundle["model_config"])), "stac": dict(
            DIST, fit_offsets_path="fit.h5", ik_only_path="ik.h5", data_path=str(tmp / "recording.mat"),
            n_fit_frames=N_FIT, n_frames_per_clip=CLIP)}
        _write_mat(config_from_dict(conf), main_run["kp"].cpu().numpy(), tmp / "recording.mat")
        np.save(tmp / "main_offsets.npy", fit0.offsets)
        spec = {"config": conf, "device": str(device)}
        for tag in ("nccl1", "gloo2"):  # each run writes its artifacts in a directory of its own
            (tmp / tag).mkdir()
        one = _start_ranks("nccl1", 1, dict(spec, backend="nccl", dir=str(tmp / "nccl1")), tmp)
        two = _start_ranks("gloo2", 2, dict(spec, backend="gloo", dir=str(tmp / "gloo2"), capture_F=N_FIT // 2,
                                            ik_main_offsets=str(tmp / "main_offsets.npy")), tmp)
        try:
            (r1,), (ra, rb) = _join_ranks("nccl1", one, tmp), _join_ranks("gloo2", two, tmp)
        finally:
            for proc in one + two:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()

    def quality(r):
        return (_resid(r["fit_markers"], r["fit_kp"], N_FIT), float(np.abs(r["fit_offsets"] - main_run["true_off"]).mean()),
                _resid(r["ik_markers"], r["ik_kp"], N_IK))

    q_main = (main_run["fit_resid"], main_run["off_err"], main_run["ik_resid"])
    q1, q2 = quality(r1), quality(ra)
    names = ("fit residual", "offset error", "ik residual")
    d1 = max(float(np.abs(r1["fit_qpos"] - fit0.qpos).max()), float(np.abs(r1["ik_qpos"] - ik0.qpos).max()))
    a2 = _ik_agreement(main_run, ra["ik_main_qpos"])
    print(f"distributed: nccl world 1, {smi}: launches {r1['launches'].tolist()}; "
          + ", ".join(f"{n} {_fmt_mm(a)} mm (main {_fmt_mm(b)})" for n, a, b in zip(names, q1, q_main))
          + f"; max |qpos - main| {d1:.3e}; walls run/fit/ik {', '.join(f'{w:.3f}' for w in r1['walls'])} s")
    print(f"distributed: gloo world 2 on one card: launches per rank {ra['launches'].tolist()}, "
          f"{rb['launches'].tolist()}; "
          + ", ".join(f"{n} {_fmt_mm(a)} mm ({a / b:.4f}x main)" for n, a, b in zip(names, q2, q_main))
          + f"; walls run/fit/ik rank 0 {', '.join(f'{w:.3f}' for w in ra['walls'])} s")
    print(f"distributed: ik of each rank's 20 clips at the main offsets, launches {int(ra['ik_main_launches'])} per "
          f"rank: {_agreement_line(a2)}")
    F_cap, err_plain, err_f64, finite = ra["capture"]
    print(f"distributed: K1 on a rank's fit systems, F = {int(F_cap)}: vs plain {err_plain:.3e}, vs f64 "
          f"{err_f64:.3e} (bound {KERNEL_REL_TOL}); phase wall {time.perf_counter() - t_phase:.2f} s")
    same = all(np.array_equal(ra[k], rb[k]) for k in ra if k not in ("walls", "capture", "launches", "fk"))
    _check_all("distributed", {
        f"world 1 launched the kernel {MAIN_LAUNCHES[0]} + {MAIN_LAUNCHES[1]} times":
            tuple(r1["launches"]) == MAIN_LAUNCHES,
        "world 1 residuals and offset error equal the main phase's to the printed digit":
            all(_fmt_mm(a) == _fmt_mm(b) for a, b in zip(q1, q_main)),
        f"world 1 qpos within {DIST_QPOS_ABS} of the main phase's": d1 <= DIST_QPOS_ABS,
        "world 2: both ranks' gathered outputs bitwise equal": same,
        f"world 2 fit residual and offset error < {FIT_RESID_MAX * 1e3} mm, at most {DIST_REL:.0%} above main":
            all(a < FIT_RESID_MAX and a <= (1 + DIST_REL) * b for a, b in zip(q2[:2], q_main[:2])),
        f"world 2 ik residual < {IK_RESID_MAX * 1e3} mm": q2[2] < IK_RESID_MAX,
        f"world 2 ik at the main offsets within {DIST_QPOS_ABS} of the main phase's qpos": a2["dq"] <= DIST_QPOS_ABS,
        "world 2 outputs finite, full shapes": bool(np.isfinite(ra["ik_qpos"]).all()) and ra["ik_qpos"].shape
            == (N_IK, 44) and ra["fit_qpos"].shape == (N_FIT, 44),
        f"K1 at F = {int(F_cap)} within bound of plain and f64, finite":
            err_plain < KERNEL_REL_TOL and err_f64 < KERNEL_REL_TOL and bool(finite),
    })
    print(f"distributed: FK kernel launches world 1 {int(r1['fk'])}, world 2 per rank {int(ra['fk'])} and "
          f"{int(rb['fk'])}, the ik at the main offsets {int(ra['ik_main_fk'])} per rank")
    return {"launches": int(r1["launches"].sum()), "launches_2": int(ra["launches"].sum() + rb["launches"].sum()
                                                                         + ra["ik_main_launches"] + rb["ik_main_launches"]),
            "fk": int(r1["fk"]), "fk_2": int(ra["fk"] + rb["fk"] + ra["ik_main_fk"] + rb["ik_main_fk"])}


# Phase 12: the options, at the main path's sizes. OPT_REL: stall freezing
# stops a lane only after 3 iterations without a gain above FTOL^2, so its
# residuals stay within 2% of the fixed count's. WIRE_ABS: float16 keypoints
# centred on the recording's mean are quantised to ~1e-4 m
# (tests/test_pipeline.py::test_wire_f16_matches_f32's bound).
OPT_REL = 0.02
WIRE_ABS = 2e-4
CHUNK, SEQ_CLIPS, SEQ_CLIP = 8, 40, 6
CHUNKS, SMALL_CHUNK_CLIPS = (1, 2, 4, 5), 10
# The sequential gn-lm ik of SEQ_CLIPS clips: 2 root passes and SEQ_CLIP
# frames, one 14-iteration LM solve each, the clips on the lanes.
SEQ_LAUNCHES = 14 * (2 + SEQ_CLIP)


def phase_options(spd, device, bundle, main_run, smi: str) -> dict:
    from stac_mjx_tpu_torch.stac import Stac

    t_phase = time.perf_counter()
    kp, fit0, ik0 = main_run["kp"], main_run["fit"], main_run["ik"]
    kp_host = kp.cpu().numpy()
    cfg = dict(THROUGHPUT, n_fit_frames=N_FIT, n_frames_per_clip=CLIP)
    launches, fk, checks = {}, {}, {}
    launched = _launches()

    def fit_ik(stac, what):
        launched.clear()
        fit, fit_s = _sync_time(lambda: stac.fit_offsets(kp[:N_FIT]))
        n_fit = launched["spd_chol"]
        ik, ik_s = _sync_time(lambda: stac.ik_only(kp, fit.offsets))
        n_ik, fk[what] = launched["spd_chol"] - n_fit, launched["fk_jump"]
        _, _, fit_markers = stac.compute_full_outputs(fit.qpos)  # at fit.offsets
        _, _, ik_markers = stac.compute_full_outputs(ik.qpos)
        return ((n_fit, n_ik), (fit_s, ik_s),
                (_resid(fit_markers, fit.kp_data, N_FIT), _resid(ik_markers, kp_host, N_IK)), fit)

    main_q = (main_run["fit_resid"], main_run["ik_resid"])
    (lf, li), (fs, is_), q, _ = fit_ik(Stac(bundle, dict(cfg, gn_stall_iters=3), device=device), "stall")
    launches["stall"] = lf + li
    print(f"options: gn_stall_iters=3 ({smi}): fit {fs:.3f} s (main {main_run['fit_s']:.3f}), ik {is_:.3f} s (main "
          f"{main_run['ik_s']:.3f}); K1 launches {lf} + {li} (fixed count {MAIN_LAUNCHES[0]} + {MAIN_LAUNCHES[1]}); "
          f"fit/ik residual {_fmt_mm(q[0])}/{_fmt_mm(q[1])} mm (main {_fmt_mm(main_q[0])}/{_fmt_mm(main_q[1])})")
    checks[f"stall: launches at most {MAIN_LAUNCHES}"] = lf <= MAIN_LAUNCHES[0] and li <= MAIN_LAUNCHES[1]
    checks[f"stall: residuals within {OPT_REL:.0%} of main"] = all(abs(a - b) <= OPT_REL * b for a, b in zip(q, main_q))

    (lf, li), (fs, is_), q, wfit = fit_ik(Stac(bundle, dict(cfg, wire_dtype="float16"), device=device), "wire16")
    launches["wire16"] = lf + li
    print(f"options: wire_dtype=float16: fit {fs:.3f} s, ik {is_:.3f} s; K1 launches {lf} + {li}; residual of the "
          f"markers recomputed from the upcast qpos, fit/ik {_fmt_mm(q[0])}/{_fmt_mm(q[1])} mm (main "
          f"{_fmt_mm(main_q[0])}/{_fmt_mm(main_q[1])}); offset error "
          f"{_fmt_mm(float(np.abs(wfit.offsets - main_run['true_off']).mean()))} mm; qpos dtype {wfit.qpos.dtype}")
    checks[f"wire16: residuals within {WIRE_ABS} m of main"] = all(abs(a - b) <= WIRE_ABS for a, b in zip(q, main_q))
    checks["wire16: launches as the main path's"] = (lf, li) == MAIN_LAUNCHES

    stacs = {"one": Stac(bundle, cfg, device=device), "chunked": Stac(bundle, dict(cfg, ik_chunk_clips=CHUNK),
                                                                       device=device)}
    runs = {"one": [], "chunked": []}  # (wall, K1 launches, qpos, FK launches) per run, in turns
    with _capturing(lambda A, lam: A.shape[0] == CHUNK * CLIP and lam is not None) as captured:
        for what in ("one", "chunked", "chunked", "one"):
            launched.clear()
            ik, wall = _sync_time(lambda st=stacs[what]: st.ik_only(kp, fit0.offsets))
            runs[what].append((wall, launched["spd_chol"], ik.qpos, launched["fk_jump"]))
    A, g, lam = captured[0]
    c_plain, c_f64, c_fin = _kernel_vs_plain(spd, A, g, lam)
    launches["chunked"] = sum(r[1] for rs in runs.values() for r in rs)
    fk["chunked"] = sum(r[3] for rs in runs.values() for r in rs)
    agree = {what: _ik_agreement(main_run, rs[0][2]) for what, rs in runs.items()}
    repeat = {what: bool(np.array_equal(rs[0][2], rs[1][2])) for what, rs in runs.items()}
    print(f"options: ik in chunks of {CHUNK} clips vs one batch, walls in turns: one "
          f"{', '.join(f'{r[0]:.3f}' for r in runs['one'])} s, chunked {', '.join(f'{r[0]:.3f}' for r in runs['chunked'])}"
          f" s; K1 launches per ik {runs['chunked'][0][1]} vs {runs['one'][0][1]}; repeat runs bitwise equal {repeat}; "
          f"K1 at F = {A.shape[0]} vs plain {c_plain:.3e}, vs f64 {c_f64:.3e}")
    for what, a in agree.items():
        print(f"options: {what} vs the main phase's ik: {_agreement_line(a)}")
        checks[f"{what}: ik qpos within {DIST_QPOS_ABS} of the main phase's"] = a["dq"] <= DIST_QPOS_ABS
    checks[f"chunked: K1 at F = {CHUNK * CLIP} within bound"] = (
        c_plain < KERNEL_REL_TOL and c_f64 < KERNEL_REL_TOL and c_fin)

    # Batch invariance (GNIK._gradient, GNIK._row_sum): the ik in chunks of
    # CHUNKS clips equals one batch bitwise, the root solve then running on
    # 1 ... 8 clips' first frames. Chunks of 1 and 2 run on the first
    # SMALL_CHUNK_CLIPS clips only (a chunk costs a whole ik's dispatch).
    one = runs["one"][0][2]
    for chunk in CHUNKS:
        n_clips = SMALL_CHUNK_CLIPS if chunk < 4 else N_IK // CLIP
        st = Stac(bundle, dict(cfg, ik_chunk_clips=chunk), device=device)
        launched.clear()
        ik, wall = _sync_time(lambda st=st: st.ik_only(kp[: n_clips * CLIP], fit0.offsets))
        n = launched["spd_chol"]
        launches["chunked"] += n
        fk["chunked"] += launched["fk_jump"]
        dq = float(np.abs(ik.qpos - one[: n_clips * CLIP]).max())
        print(f"options: ik of {n_clips} clips in chunks of {chunk} ({n_clips // chunk} chunks) vs one batch of 40: "
              f"max |qpos delta| {dq:.3e}, K1 launches {n} ({MAIN_LAUNCHES[1]} per chunk), wall {wall:.3f} s")
        checks[f"chunks of {chunk}: ik qpos bitwise equal to one batch"] = dq == 0.0
        checks[f"chunks of {chunk}: K1 launches {MAIN_LAUNCHES[1]} per chunk"] = n == MAIN_LAUNCHES[1] * (n_clips // chunk)
    checks[f"chunks of {CHUNK}: ik qpos bitwise equal to one batch"] = bool(np.array_equal(runs["chunked"][0][2], one))

    st = Stac(bundle, dict(THROUGHPUT, pose_mode="sequential", n_frames_per_clip=SEQ_CLIP), device=device)
    with _capturing(lambda A, lam: A.shape[0] == SEQ_CLIPS and lam is None) as captured:
        launched.clear()
        seq, wall = _sync_time(lambda: st.ik_only(kp[: SEQ_CLIPS * SEQ_CLIP], fit0.offsets))
        launches["sequential"], fk["sequential"] = launched["spd_chol"], launched["fk_jump"]
    A, g, lam = captured[0]
    s_plain, s_f64, s_fin = _kernel_vs_plain(spd, A, g, lam)
    print(f"options: sequential gn-lm ik, {SEQ_CLIPS} clips of {SEQ_CLIP} frames in one call: wall {wall:.3f} s; "
          f"K1 launches {launches['sequential']}; K1 on the lanes, F = {A.shape[0]}: vs plain {s_plain:.3e}, "
          f"vs f64 {s_f64:.3e}; qpos finite {bool(np.isfinite(seq.qpos).all())}")
    checks["sequential: qpos finite"] = bool(np.isfinite(seq.qpos).all())
    checks[f"sequential: K1 launches {SEQ_LAUNCHES}"] = launches["sequential"] == SEQ_LAUNCHES
    checks[f"sequential: K1 at F = {SEQ_CLIPS} within bound"] = s_plain < KERNEL_REL_TOL and s_f64 < KERNEL_REL_TOL and s_fin
    print(f"options: FK kernel launches {fk}; phase wall {time.perf_counter() - t_phase:.2f} s")
    checks[f"stall: FK kernel launches at most {sum(MAIN_FK_LAUNCHES)}"] = fk["stall"] <= sum(MAIN_FK_LAUNCHES)
    _check_all("options", checks)
    return {"launches": launches, "fk": fk}


def phase_profiling(spd, main_run) -> dict:
    """device_trace around one main-path ik; op_table must name K1's kernel
    with the ik's 34 launches, report() must hold the ik_only phase."""
    from stac_mjx_tpu_torch.utils import profiling

    stac, kp, fit = main_run["stac"], main_run["kp"], main_run["fit"]
    profiling.reset()
    with tempfile.TemporaryDirectory() as logdir:
        profiling.LAUNCHES.clear()
        with profiling.device_trace(logdir):
            stac.ik_only(kp, fit.offsets)
        n, n_fk = profiling.LAUNCHES["spd_chol"], profiling.LAUNCHES["fk_jump"]
        table = profiling.op_table(logdir, top=10**6)
    k1 = [o for o in table["ops"] if "spd_chol" in o["op"]]
    k2 = [o for o in table["ops"] if "fk_jump" in o["op"]]
    rep = profiling.report()
    top = ", ".join(f"{o['op'][:40]} {o['us']:.0f} us x{o['count']}" for o in table["ops"][:4])
    print(f"profiling: traced ik: {len(table['ops'])} kernels, {table['total_op_us'] / 1e3:.3f} ms of kernel time, "
          f"copies {table['copy_formatting_pct']}%; K1 {k1[0]['op'] if k1 else 'absent'}: "
          f"{k1[0]['count'] if k1 else 0} launches, {k1[0]['us'] if k1 else 0:.1f} us; FK kernel "
          f"{k2[0]['count'] if k2 else 0} launches (counted {n_fk}); top: {top}; report {rep}")
    _check_all("profiling", {
        f"op_table lists K1 with {MAIN_LAUNCHES[1]} launches": len(k1) == 1 and k1[0]["count"] == MAIN_LAUNCHES[1] == n,
        "op_table lists the FK kernel with the counted launches": len(k2) == 1 and k2[0]["count"] == n_fk,
        "report() holds ik_only": rep.get("ik_only", {}).get("count") == 1,
    })
    return {"launches": n, "fk": n_fk}


# Phase 14: the model. run_stac on the main path's configuration with the
# full payload, over phase 10's recording (a DANNCE .mat), the artifacts in
# the in-memory store. (a) firstparty's model config with the keys that shape
# no compiled array changed: the checked-in bundle serves it and the Stac
# derives the rest, with no mujoco. (b) where mujoco imports: firstparty
# compiled by the port's builder (held against the checked-in bundle), run as
# phase 10 was; then a config no bundle serves, every initial offset moved by
# a seeded +-MOVED_M per coordinate (MOVED_SEED), compiled and run.
MODEL_RUN = dict(THROUGHPUT, ik_return_full=True, infer_qvels=False)
MOVED_M, MOVED_SEED = 3e-3, 14
# The set-up keys a model config may leave out (configs/model/celegans.yaml
# has no root keypoint).
OPTIONAL_SETUP_KEYS = ("ROOT_OPTIMIZATION_KEYPOINT", "INDIVIDUAL_PART_OPTIMIZATION", "SITES_TO_REGULARIZE")
# Under another mujoco release than the one that compiled the bundles, the
# built model's float64 arrays are held to this.
BUILT_ABS = 1e-12


def _setup_only_change(model: dict) -> dict:
    """firstparty's model config with ROOT_OPTIMIZATION_KEYPOINT TorsoF and one
    entry dropped from TRUNK_OPTIMIZATION_KEYPOINTS and from
    INDIVIDUAL_PART_OPTIMIZATION."""
    model = copy.deepcopy(model)
    model["ROOT_OPTIMIZATION_KEYPOINT"] = "TorsoF"
    model["TRUNK_OPTIMIZATION_KEYPOINTS"] = model["TRUNK_OPTIMIZATION_KEYPOINTS"][:-1]
    parts = model["INDIVIDUAL_PART_OPTIMIZATION"]
    parts.pop(list(parts)[-1])
    return model


@contextlib.contextmanager
def _no_checked_in_bundles():
    """While active, bridge.bundle_for_config finds no checked-in bundle, so it
    compiles the model from its MJCF (``models/builder.bundle_arrays``)."""
    from stac_mjx_tpu_torch import bridge

    assets = bridge.ASSETS
    with tempfile.TemporaryDirectory() as empty:
        bridge.ASSETS = Path(empty)
        try:
            yield
        finally:
            bridge.ASSETS = assets


def _run_stac_in_memory(spd, device, conf: dict, kp_host: np.ndarray) -> dict:
    """run_stac on the card over kp_host written as a DANNCE .mat, the
    artifacts in the in-memory store: the fit and ik StacData, K1's launches
    (fit, ik), the wall and the Stac that run_stac made."""
    from stac_mjx_tpu_torch import io
    from stac_mjx_tpu_torch import main as driver
    from stac_mjx_tpu_torch.config import config_from_dict

    cfg = config_from_dict(copy.deepcopy(conf))
    times, launches, made = {}, {}, []
    launched = _launches()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        _write_mat(cfg, kp_host, tmp / "recording.mat")
        kp_data, names = io.load_data(cfg, base_path=tmp)
        with contextlib.ExitStack() as stack:
            stack.enter_context(_MemoryArtifacts(io).installed())
            stack.enter_context(_timed(driver, "make_stac", times, made.append))
            stack.enter_context(_timed(driver, "fit_phase", times,
                                       lambda _: launches.__setitem__("fit", launched["spd_chol"])))
            launched.clear()
            (fit_path, ik_path), run_s = _sync_time(lambda: driver.run_stac(cfg, kp_data, names, base_path=tmp,
                                                                             device=device))
            launches["ik"], launches["fk"] = launched["spd_chol"] - launches["fit"], launched["fk_jump"]
            (_, fit), (_, ik) = io.load_stac_data(fit_path), io.load_stac_data(ik_path)
    return {"fit": fit, "ik": ik, "launches": (launches["fit"], launches["ik"]), "fk": launches["fk"], "run_s": run_s,
            "model_s": times["make_stac"], "stac": made[0]}


def _quality(run: dict, true_off) -> tuple[float, float, float]:
    fit, ik = run["fit"], run["ik"]
    return (_resid(fit.marker_sites, fit.kp_data, fit.qpos.shape[0]), _resid(ik.marker_sites, ik.kp_data, ik.qpos.shape[0]),
            float(np.abs(fit.offsets - true_off).mean()))


def _quality_checks(tag: str, run: dict, q) -> dict:
    return {
        f"{tag}: fit launched the kernel {MAIN_LAUNCHES[0]} times": run["launches"][0] == MAIN_LAUNCHES[0],
        f"{tag}: ik launched the kernel {MAIN_LAUNCHES[1]} times": run["launches"][1] == MAIN_LAUNCHES[1],
        f"{tag}: fit residual < {FIT_RESID_MAX * 1e3} mm": q[0] < FIT_RESID_MAX,
        f"{tag}: ik residual < {IK_RESID_MAX * 1e3} mm": q[1] < IK_RESID_MAX,
        f"{tag}: offset error < {OFFSET_ERR_MAX * 1e3} mm": q[2] < OFFSET_ERR_MAX,
        f"{tag}: qpos finite, full shapes": bool(np.isfinite(run["ik"].qpos).all()) and run["ik"].qpos.shape == (N_IK, 44)
            and run["fit"].qpos.shape == (N_FIT, 44),
    }


def _quality_line(run: dict, q) -> str:
    return (f"K1 launches {run['launches'][0]} (fit) + {run['launches'][1]} (ik); fit residual {_fmt_mm(q[0])} mm, "
            f"ik residual {_fmt_mm(q[1])} mm, offset error vs ground truth {_fmt_mm(q[2])} mm; run_stac "
            f"{run['run_s']:.3f} s, of which the model {run['model_s']:.3f} s")


def phase_model(spd, device, bundle, main_run, driver_run, smi: str) -> dict:
    """(a) a set-up-only change of firstparty's model config on the checked-in
    bundle; (b) where mujoco imports, the port's builder: firstparty built
    against the bundle and run as phase 10, then a config no bundle serves."""
    import stac_mjx_tpu_torch.models.builder as builder
    from stac_mjx_tpu_torch import bridge
    from stac_mjx_tpu_torch.config import config_from_dict
    from stac_mjx_tpu_torch.models.setup import model_setup

    t_phase = time.perf_counter()
    try:
        mujoco = builder.import_mujoco()
    except ImportError as e:
        mujoco = None
        print(f"model: mujoco does not import here ({e!r}): part (b), the port's builder on this host, is left out")
    kp_host, true_off = main_run["kp"].cpu().numpy(), main_run["true_off"]
    recorded = json.loads(str(bundle["model_config"]))
    stac_conf = dict(MODEL_RUN, fit_offsets_path="fit.h5", ik_only_path="ik.h5", data_path="recording.mat",
                     n_fit_frames=N_FIT, n_frames_per_clip=CLIP, skip_fit_offsets=False, skip_ik_only=False)
    checks, launches, fk, runs = {}, 0, 0, 1

    # (a) The set-up-only change, and the set-up of the recorded config.
    stored = model_setup(recorded, bundle)
    same_setup = all(np.array_equal(np.asarray(v), bundle[k]) for k, v in stored.items())
    changed = _setup_only_change(recorded)
    run = _run_stac_in_memory(spd, device, {"model": changed, "stac": stac_conf}, kp_host)
    launches += sum(run["launches"])
    fk += run["fk"]
    st, q = run["stac"], _quality(run, true_off)
    kp_names = list(changed["KEYPOINT_MODEL_PAIRS"])
    print(f"model (a): {smi}: ROOT_OPTIMIZATION_KEYPOINT TorsoF (index {st._root_kp_idx}), "
          f"{int(st._trunk_kps.sum())} trunk keypoints, {len(st._indiv_parts)} parts, on the checked-in bundle; "
          + _quality_line(run, q))
    checks.update(_quality_checks("(a)", run, q))
    checks["(a): the recorded config's set-up equals the bundle's stored arrays"] = same_setup
    checks["(a): the Stac's set-up is the changed config's"] = (
        st._root_kp_idx == kp_names.index("TorsoF") and int(st._trunk_kps.sum()) == len(
            changed["TRUNK_OPTIMIZATION_KEYPOINTS"]) and len(st._indiv_parts) == len(changed["INDIVIDUAL_PART_OPTIMIZATION"]))
    # Keys left out of the config stay out (as in the JAX Stac), not filled
    # from the bundle's recorded config: no root solve, parts or regularised sites.
    from stac_mjx_tpu_torch.main import make_stac

    left_out = {k: v for k, v in recorded.items() if k not in OPTIONAL_SETUP_KEYS}
    sd = make_stac(config_from_dict({"model": left_out, "stac": stac_conf}), kp_names, device=device)
    print(f"model (a): without {', '.join(OPTIONAL_SETUP_KEYS)}: root keypoint index {sd._root_kp_idx}, "
          f"{len(sd._indiv_parts)} parts, {int(sd._is_regularized.sum().item())} regularised coordinates")
    checks["(a): keys left out of the model config stay out"] = (
        sd._root_kp_idx == -1 and not sd._indiv_parts and not bool(sd._is_regularized.any())
        and not sd._static_cfg.do_root_opt)

    # (b) The port's builder on this host.
    if mujoco is not None:
        cfg = config_from_dict({"model": copy.deepcopy(recorded), "stac": stac_conf})
        built, build_s = _sync_time(lambda: builder.bundle_arrays(cfg, ROOT))
        exact = sorted(built) == sorted(bundle) and all(
            built[k].dtype == bundle[k].dtype and np.array_equal(built[k], bundle[k]) for k in bundle)
        worst = max(float(np.abs(built[k] - bundle[k]).max()) for k in bridge.KINPARAMS_FIELDS + ("jnt_range",))
        same_release = mujoco.__version__ == bridge.BUNDLE_MUJOCO_VERSION
        print(f"model (b): mujoco {mujoco.__version__} (the bundles': {bridge.BUNDLE_MUJOCO_VERSION}); firstparty "
              f"built from models/firstparty.xml in {build_s:.3f} s: {'bitwise equal to' if exact else 'differs from'} "
              f"the checked-in bundle, largest difference {worst:.3e}")
        checks["(b): the built firstparty equals the checked-in bundle" + (
            "" if same_release else f" to {BUILT_ABS}")] = exact if same_release else worst <= BUILT_ABS
        with _no_checked_in_bundles():
            again = _run_stac_in_memory(spd, device, driver_run["conf"], kp_host)
            rng = np.random.default_rng(MOVED_SEED)
            moved = copy.deepcopy(recorded)
            moved["KEYPOINT_INITIAL_OFFSETS"] = {
                k: [float(x) for x in np.add(v, rng.uniform(-MOVED_M, MOVED_M, 3))]
                for k, v in recorded["KEYPOINT_INITIAL_OFFSETS"].items()}
            unserved = _run_stac_in_memory(spd, device, {"model": moved, "stac": stac_conf}, kp_host)
        launches += sum(again["launches"]) + sum(unserved["launches"])
        fk += again["fk"] + unserved["fk"]
        runs += 2
        fit0, ik0 = driver_run["fit"], driver_run["ik"]
        d = max(float(np.abs(np.asarray(a) - np.asarray(b)).max()) for a, b in (
            (again["fit"].qpos, fit0.qpos), (again["fit"].offsets, fit0.offsets), (again["ik"].qpos, ik0.qpos),
            (again["ik"].qvel, ik0.qvel)))
        print(f"model (b): run_stac on the built firstparty as phase 10: max |delta| of fit qpos, offsets, ik qpos "
              f"and qvel against phase 10 {d:.3e}; K1 launches {again['launches']}")
        checks["(b): run_stac on the built model equals phase 10" + ("" if exact else " to 1e-6")] = (
            d == 0.0 if exact else d <= 1e-6)
        checks[f"(b): K1 launches {MAIN_LAUNCHES} on the built model"] = again["launches"] == MAIN_LAUNCHES
        q = _quality(unserved, true_off)
        print(f"model (b): initial offsets moved by +-{MOVED_M * 1e3:g} mm (seed {MOVED_SEED}), no bundle serves it, "
              f"compiled on this host: " + _quality_line(unserved, q))
        checks.update(_quality_checks("(b) moved offsets", unserved, q))
    print(f"model: phase wall {time.perf_counter() - t_phase:.2f} s; FK kernel launches {fk}")
    _check_all("model", checks)
    return {"launches": launches, "fk": fk, "runs": runs}


# Phase 15: the rest of the JAX package's public surface on the card.
# COM_ABS: subtree_com in float32 on the card against float64 on the CPU, on
# the same float32 body frames; the frames are O(0.3 m), a float32 rounding
# of them ~3e-8 m, and a subtree's mass-weighted sum over at most 19 bodies,
# one rotation and one division keep the error near 1e-7 m: bounded at 1e-5.
COM_ABS = 1e-5
COM_WALL_MAX_S = 1.0
# The synth demo fits the model's own FK of its keypoint at the configured
# offset: both packages print 0.0000 mm on the CPU. Bound: 1e-5 m, float32
# rounding with a wide margin (the main path's residual is ~2e-3 m).
DEMO_RESID_MAX = 1e-5
# recompute_errors: card float32 against CPU float64 on the same artifact;
# 5.8e-6 relative on the CPU at float32 (400 frames), bounded at 1e-4.
ERRORS_REL = 1e-4
FIRSTPARTY_ASSETS = ("models/firstparty.xml", "configs/model/firstparty.yaml", "configs/stac/firstparty.yaml")


def _load_demo(name: str):
    """A script of demos/ as a module."""
    spec = importlib.util.spec_from_file_location(name, ROOT / "demos" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@contextlib.contextmanager
def _linesearch_steps():
    """While active, counts the loop steps of the linesearch GN
    (``GNIK._linesearch_gn``, its two nested ``while_lanes``): "iterations",
    outer steps, each one kernel solve; "retries", linesearch steps, each
    one more. So a run launches K1 exactly iterations + retries times."""
    from stac_mjx_tpu_torch.ops import gn_ik

    counts = {"solves": 0, "iterations": 0, "retries": 0}
    loop, depth = gn_ik.while_lanes, [0]

    def counting(cond, body, state):
        level = depth[0]
        counts["solves"] += level == 0

        def counted(s, active):
            counts["iterations" if level == 0 else "retries"] += 1
            depth[0] += 1
            try:
                return body(s, active)
            finally:
                depth[0] -= 1

        return loop(cond, counted, state)

    gn_ik.while_lanes = counting
    try:
        yield counts
    finally:
        gn_ik.while_lanes = loop


def phase_surface(spd, device, main_run, driver_run, smi: str) -> dict:
    """subtree_com and make_site_fk over the main path's ik frames, the synth
    demo through the linesearch GN and K1, the graph-error demo's
    recompute_errors on the driver phase's artifact, write_assets."""
    from stac_mjx_tpu_torch import io
    from stac_mjx_tpu_torch.bridge import load_inertia
    from stac_mjx_tpu_torch.config import config_from_dict
    from stac_mjx_tpu_torch.models.firstparty import write_assets
    from stac_mjx_tpu_torch.models.kinematics import make_fk, make_site_fk, subtree_com

    t_phase = time.perf_counter()
    checks = {}

    # subtree_com over the main path's 10,000 ik frames: their body frames by
    # the main Stac's FK at the fit's offsets (what compute_full_outputs
    # gives), with params of this phase's own.
    stac = main_run["stac"]
    params = stac.params.set_site_pos(torch.as_tensor(main_run["fit"].offsets, device=device),
                                      stac.stac_core_obj.site_idxs_t)
    qpos = torch.as_tensor(main_run["ik"].qpos, device=device)
    frames = stac.stac_core_obj.fk(params, qpos)
    x, q = frames.xpos, frames.xquat
    mass, ipos = load_inertia()
    com = subtree_com(stac.topo, mass, ipos, device)
    com(x, q)  # first call: the tables rounded to float32
    got, com_s = _sync_time(lambda: com(x, q))
    com_ms = _stream_ms(lambda: com(x, q), 20)
    traced = _device_kernels(lambda: com(x, q), 20)
    with _one_cpu_thread():
        ref = subtree_com(stac.topo, mass, ipos, "cpu")(x.cpu().double(), q.cpu().double())
    com_err = float((got.cpu().double() - ref).abs().max())
    kernels = ", ".join(f"{name[:60]} {us:.1f} us x{n:g}" for name, (n, us) in traced.items())
    print(f"surface: subtree_com over {tuple(got.shape)} (the main ik's frames, {len(stac.topo.levels)} levels) on the "
          f"card ({smi}) in {com_s * 1e3:.3f} ms, {com_ms:.4f} ms per call on the stream (20 calls); vs cpu f64 max |delta| "
          f"{com_err:.3e} m (bound {COM_ABS}); total mass {mass.sum():.6f}")
    print(f"surface: subtree_com traced (torch.profiler, per call of 20): {sum(n for n, _ in traced.values()):g} "
          f"launches, {sum(us for _, us in traced.values()):.1f} us of device time: {kernels}")
    checks.update({
        f"subtree_com within {COM_ABS} m of cpu f64, finite, ({N_IK}, 20, 3)":
            com_err <= COM_ABS and bool(torch.isfinite(got).all()) and tuple(got.shape) == (N_IK, 20, 3),
        f"subtree_com under {COM_WALL_MAX_S} s": com_s < COM_WALL_MAX_S,
    })

    # make_site_fk against the level-scan FK's site rows.
    idx = stac._body_site_idxs
    sites, site_s = _sync_time(lambda: make_site_fk(stac.topo, idx, device)(params, qpos))
    full = make_fk(stac.topo, device)(params, qpos).site_xpos[:, idx]
    print(f"surface: make_site_fk {tuple(sites.shape)} in {site_s:.3f} s (tables and first call): "
          f"{'bitwise equal to' if torch.equal(sites, full) else 'differs from'} make_fk(...).site_xpos[:, idx]")
    checks["make_site_fk bitwise equal to make_fk's site rows"] = torch.equal(sites, full)

    # The synth demo (demos/torch_synth_data_demo.py, what its main runs) on
    # the card: lockstep, the linesearch GN, K1 on its damped solves.
    demo = _load_demo("torch_synth_data_demo")

    def pose_pass(A, lam):  # a pose pass's systems: one per frame
        return A.shape[0] == demo.N_FRAMES and lam is not None

    with _linesearch_steps() as steps, _capturing(pose_pass) as captured:
        launched = _launches()
        launched.clear()
        out, demo_s = _sync_time(lambda: demo.run(device))
        demo_launches, demo_fk = launched["spd_chol"], launched["fk_jump"]
    demo.report(out)
    A, g, lam = captured[0]
    d_plain, d_f64, d_fin = _kernel_vs_plain(spd, A, g, lam)
    expected = steps["iterations"] + steps["retries"]
    print(f"surface: synth demo on the card in {demo_s:.3f} s: residual {out['residual']:.3e} m, translation error "
          f"{out['drift']:.3e} m; {steps['solves']} linesearch GN solves, {steps['iterations']} iterations + "
          f"{steps['retries']} linesearch retries = {expected} K1 launches expected, {demo_launches} counted; K1 on "
          f"its systems (F = {A.shape[0]}, n = {A.shape[-1]}) vs plain {d_plain:.3e}, vs f64 {d_f64:.3e}")
    checks.update({
        f"synth demo residual < {DEMO_RESID_MAX} m": out["residual"] < DEMO_RESID_MAX,
        "synth demo launched K1 once per GN iteration and linesearch retry": demo_launches == expected > 0,
        "K1 on the demo's systems within bound of plain and f64": d_plain < KERNEL_REL_TOL and d_f64 < KERNEL_REL_TOL
            and d_fin,
    })

    # recompute_errors on the driver phase's ik artifact (the in-memory store
    # stands in for its h5 file): the card against the CPU in float64.
    errors_demo = _load_demo("torch_graph_error_demo")
    store = _MemoryArtifacts(io)
    ik = driver_run["ik"]
    store.save(config_from_dict(copy.deepcopy(driver_run["conf"])), "ik.h5", **ik.as_dict())
    with store.installed():
        (errors, _), err_s = _sync_time(lambda: errors_demo.recompute_errors("ik.h5", base_path=ROOT, device=device))
        with _one_cpu_thread():
            errors64, _ = errors_demo.recompute_errors("ik.h5", base_path=ROOT, device="cpu", dtype=torch.float64)
    rel = float((np.abs(errors - errors64) / np.maximum(errors64, 1e-30)).max())
    print(f"surface: recompute_errors on the driver's ik artifact {errors.shape} in {err_s:.3f} s: mean {errors.mean():.6e} "
          f"m^2, {int((errors > 0.005).sum())} frames above 0.005; card f32 vs cpu f64 max rel {rel:.3e} "
          f"(bound {ERRORS_REL})")
    checks[f"recompute_errors within {ERRORS_REL} relative of cpu f64"] = rel <= ERRORS_REL and errors.shape == (N_IK,)

    # write_assets: the first-party MJCF and configs, byte for byte.
    with tempfile.TemporaryDirectory() as tmp:
        for rel_path in FIRSTPARTY_ASSETS:
            (Path(tmp) / rel_path).parent.mkdir(parents=True, exist_ok=True)
        write_assets(tmp)
        same = [(Path(tmp) / p).read_bytes() == (ROOT / p).read_bytes() for p in FIRSTPARTY_ASSETS]
    checks["write_assets byte-equal to the checked-in files"] = all(same)
    print(f"surface: phase wall {time.perf_counter() - t_phase:.2f} s")
    _check_all("surface", checks)
    return {"launches": demo_launches, "fk": demo_fk}


# Phase 17: the tethered fly (nv 102) at the benchmark cell's size, one
# session: every pass runs eager (F > the LM graphs' bound), 14 coarse and 6
# fine LM iterations, each one launch of the wide kernel at width 104.
FLY_CELL = "fly-lm.ik-session"
FLY_SEED = 16
FLY_LAUNCHES = {104: 20}


def phase_fly(spd, device, smi: str) -> dict:
    """The fly's ik through ``Stac.ik_only`` as the benchmark's ``ik_fixed``
    job runs it (its first fixed session, 600 clips of 300 frames): launches
    by width, the poses judged by the float64 reference against the cell's
    limits (true mm), and K1 on the coarse pass's captured systems against
    its plain version and float64."""
    from portbench.harness import check, spec
    from portbench.jobs import ik_fixed

    cell = spec.Cell(FLY_CELL)
    cell.traffic["pool"] = 1
    job, make_s = _sync_time(lambda: ik_fixed.Job(cell, FLY_SEED, device))
    per_clip, stride = int(job.cfg["stac"]["n_frames_per_clip"]), int(job.cfg["stac"]["ik_hier_stride"])
    coarse_f = int(cell.traffic["clips"]) * -(-per_clip // stride)  # every stride-th frame of each clip
    with _capturing(lambda A, lam: A.shape[0] == coarse_f and lam is not None) as captured:
        _, warm_s = _sync_time(lambda: job.call(0))  # first call: the cell's shapes warmed
    launched = _launches()
    launched.clear()
    torch.cuda.reset_peak_memory_stats(device)
    record, ik_s = _sync_time(lambda: job.call(0))
    launches, by_width, fk_launches = launched["spd_chol"], spd.launches_by_width(launched), launched["fk_jump"]
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    A, g, lam = captured[0]
    c_plain, c_f64, c_fin = _kernel_vs_plain(spd, A, g, lam)
    del captured, A, g, lam
    job.release()
    res = job.evaluate([record])
    ok, checks = check.judge(res["numbers"], cell.limits)
    frames = job.frames_per_call
    print(f"fly: session {tuple(job.kp[0].shape)} made in {make_s:.3f} s; ik of {frames} frames on the card ({smi}) "
          f"in {ik_s:.3f} s ({frames / ik_s:.1f} frames/s; first call {warm_s:.3f} s), launches {launches} by width "
          f"{by_width}, peak allocated in the call {peak_gb:.2f} GB; residual {res['e2e']['residual_mm']!r} true mm; "
          + ", ".join(f"{k} {c['value']!r} (limit {c['limit']!r})" for k, c in checks.items()))
    print(f"fly: K1 on the coarse pass's systems (F = {coarse_f}, n = 102) vs plain {c_plain:.3e}, vs f64 {c_f64:.3e}; "
          f"the FK kernel launched {fk_launches} times in the call")
    _check_all("fly", {
        f"the call launched the FK kernel {FK_LAUNCHES_BY_PATH['fly']} times": fk_launches == FK_LAUNCHES_BY_PATH["fly"],
        f"ik launched the kernel {sum(FLY_LAUNCHES.values())} times, by width {FLY_LAUNCHES}":
            launches == sum(FLY_LAUNCHES.values()) and by_width == FLY_LAUNCHES,
        "qpos finite": bool(np.isfinite(record[1]).all()),
        "poses within the cell's limits": ok,
        "K1 within bound of plain and f64 on the coarse pass's systems":
            c_plain < KERNEL_REL_TOL and c_f64 < KERNEL_REL_TOL and c_fin,
    })
    torch.cuda.empty_cache()
    return {"launches": launches, "by_width": by_width, "fk": fk_launches}


# The FK phase: the cells' shapes (model, frames), the main path's ik
# shapes (coarse pass, 40 clips x 32 frames; fine pass) and the bound of
# the kernel against its plain body (tests/test_torch_fk_kernel.py's F32_REL).
FK_SHAPES = (("fly_tethered", 22_800), ("fly_tethered", 180_000), ("firstparty", 23_040), ("firstparty", 180_000),
             ("firstparty", 1_280), ("firstparty", N_IK))
FK_REL = 4e-6


def _fk_bound(F: int, dims) -> tuple[float, str]:
    """Least time (ms) of one float32 FK pass of F frames, and what bounds
    it: qpos read once and xpos, xquat, site_xpos, xanchor, xaxis written
    once, against ``peaks.fk_flops`` a frame."""
    from portbench.harness import peaks

    nbytes = F * 4 * (dims.nq + 7 * dims.nbody + 3 * dims.nsite + 6 * dims.njnt)
    flops = F * peaks.fk_flops(dims.nbody - 1, dims.njnt, dims.nsite)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def phase_fk(device) -> dict:
    """The FK kernel against its plain body at FK_SHAPES, and both timed in
    turns (kernel, plain, plain, kernel), on the stream and by device time
    (torch.profiler, as K1 is timed), beside the kernel's bound."""
    from stac_mjx_tpu_torch import bridge
    from stac_mjx_tpu_torch.models import kinematics
    from stac_mjx_tpu_torch.ops import _build

    kinematics._fk_kernel(torch.float32)
    info = _build.BUILD_INFO["fk_jump"]
    print(f"build: fk_jump.cu (nvcc {info['seconds']:.2f} s)")
    for ln in info["log"].splitlines():
        if "Compiling entry function" in ln or "Used" in ln or "spill" in ln:
            print(f"build: ptxas {ln.split(':', 1)[-1].strip()}")
    free, total = torch.cuda.mem_get_info(device)
    print(f"fk: device memory free {free / 1e9:.2f} of {total / 1e9:.2f} GB, reserved by torch "
          f"{torch.cuda.memory_reserved(device) / 1e9:.2f} GB")
    out = {}
    for name, F in FK_SHAPES:
        b = bridge.load_bundle(bridge.bundle_path(name))
        fm = bridge.fit_model_from_arrays(b, device, torch.float32)
        fk = kinematics.make_fk_jump(fm.topo, device)
        rng = np.random.default_rng(F)
        q = torch.as_tensor(np.tile(b["qpos0"], (F, 1)) + rng.normal(0, 0.4, (F, len(b["qpos0"]))),
                            dtype=torch.float32, device=device)
        got, want = fk.kernel(fm.params, q), fk.plain(fm.params, q)
        torch.cuda.synchronize()
        scale = float(want.xpos.abs().max())
        err = max(float((getattr(got, f) - getattr(want, f)).abs().max()) / (scale if f in ("xpos", "site_xpos", "xanchor") else 1.0)
                  for f in ("xpos", "xquat", "site_xpos", "xanchor", "xaxis"))
        del got, want
        fns = {"kernel": lambda: fk.kernel(fm.params, q), "plain": lambda: fk.plain(fm.params, q)}
        t = {which: {"stream": [], "device": []} for which in fns}
        for how, timer in (("stream", _stream_ms), ("device", _device_ms)):
            for which in ("kernel", "plain", "plain", "kernel"):
                fns[which]()
                torch.cuda.synchronize()
                t[which][how].append(timer(fns[which], 20))
        t = {which: {k: sum(v) / len(v) for k, v in d.items()} for which, d in t.items()}
        if not t["kernel"]["device"] > 0 < t["plain"]["device"]:
            raise AssertionError(f"fk {name} F={F}: torch.profiler recorded no device activity")
        bound_ms, bound_by = _fk_bound(F, kinematics.fk_table(fm.topo).dims)
        out[(name, F)] = dict(t, err=err, bound_ms=bound_ms, bound_by=bound_by)
        print(f"fk {name} F={F}: kernel vs plain {err:.3e} of the length scale {scale:.4f} (bound {FK_REL}); "
              f"ms per call on the stream (device ms): kernel {t['kernel']['stream']:.4f} ({t['kernel']['device']:.4f}), "
              f"plain {t['plain']['stream']:.4f} ({t['plain']['device']:.4f}); bound {bound_ms:.4f} ms ({bound_by}), "
              f"kernel device time at {100 * bound_ms / t['kernel']['device']:.1f}% of it, "
              f"{t['plain']['device'] / t['kernel']['device']:.1f}x faster than plain")
        del q
        torch.cuda.empty_cache()
    _check_all("fk", {f"kernel within {FK_REL} of plain at {FK_SHAPES}": all(v["err"] < FK_REL for v in out.values())})
    return out


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

    t_start = t0 = time.perf_counter()
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
    fk_times = phase_fk(device)  # phase 16, timed while torch.profiler still records (see its docstring)
    phase_default(device, bundle, main_run["kp"])
    drv = phase_driver(spd, device, bundle, main_run, smi)
    t_new = time.perf_counter()
    dist_run = phase_distributed(spd, device, bundle, main_run, smi)
    options = phase_options(spd, device, bundle, main_run, smi)
    prof = phase_profiling(spd, main_run)
    model = phase_model(spd, device, bundle, main_run, drv, smi)
    print(f"phases 11-14 (distributed, options, profiling, model) in {time.perf_counter() - t_new:.1f} s")
    surface = phase_surface(spd, device, main_run, drv, smi)
    fly = phase_fly(spd, device, smi)

    # launches: every path's run (the rank processes' counts included). ms, plain_ms and
    # library_ms: time per call on the stream, as since the first version of
    # this line; the *device_ms keys: torch.profiler device time.
    runs = {"main": main_run, "parts": parts, "driver": drv, "profiling": prof, "model": model, "demo": surface,
            "fly": fly}
    fk_by_path = {"distributed_1": dist_run["fk"], "distributed_2": dist_run["fk_2"], **options["fk"],
                  **{path: run["fk"] for path, run in runs.items()}}
    expected = dict(FK_LAUNCHES_BY_PATH, model=sum(MAIN_FK_LAUNCHES) * model["runs"])
    print(f"FK kernel launches by path: {fk_by_path}")
    _check_all("launches", {f"the FK kernel's launches by path are {expected}":
                            {k: fk_by_path[k] for k in expected} == expected})
    by_path = {"main": main_run["launches"], "parts": parts["launches"], "driver": drv["launches"],
               "distributed_1": dist_run["launches"], "distributed_2": dist_run["launches_2"],
               **options["launches"], "profiling": prof["launches"], "model": model["launches"],
               "demo": surface["launches"]}
    t, w = times[(37, 10_000)], times[FLY_SHAPES[-1]]
    k = fk_times[FK_SHAPES[1]]
    print(f"chip_smoke: wall {time.perf_counter() - t_start:.1f} s, the build included")
    print(json.dumps({"kernels": [{
        "name": "spd_chol_solve_f32",
        "route": "cuda",
        "source": "stac_mjx_tpu_torch/csrc/spd_chol.cu",
        "replaces": "stac_mjx_tpu/ops/spd.py:42",
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "max_abs_err": kern["max_abs_err"],
        "ms": t["kernel"]["stream"],
        "plain_ms": t["plain"]["stream"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": t["library"]["stream"],
        "device_ms": t["kernel"]["device"],
        "plain_device_ms": t["plain"]["device"],
        "library_device_ms": t["library"]["device"],
    }, {  # the layout for n past 96; times at the fly's fine pass
        "name": "spd_chol_wide_kernel",
        "route": "cuda",
        "source": "stac_mjx_tpu_torch/csrc/spd_chol.cu",
        "replaces": "stac_mjx_tpu/ops/spd.py:42",
        "launches": fly["launches"],
        "launches_by_path": {"fly": fly["launches"]},
        "launches_by_width": fly["by_width"],
        "n": FLY_SHAPES[-1][0],
        "F": FLY_SHAPES[-1][1],
        "ms": w["kernel"]["stream"],
        "plain_ms": w["plain"]["stream"],
        "bound_ms": w["bound_ms"],
        "bound_by": w["bound_by"],
        "library_ms": w["library"]["stream"],
        "device_ms": w["kernel"]["device"],
        "plain_device_ms": w["plain"]["device"],
        "library_device_ms": w["library"]["device"],
    }, {  # the FK kernel at the fly's fine pass; every timed shape below
        "name": "fk_jump_kernel",
        "route": "cuda",
        "source": "stac_mjx_tpu_torch/csrc/fk_jump.cu",
        "replaces": None,
        "launches": sum(fk_by_path.values()),
        "launches_by_path": fk_by_path,
        "F": FK_SHAPES[1][1],
        "max_rel_err": max(v["err"] for v in fk_times.values()),
        "ms": k["kernel"]["stream"],
        "plain_ms": k["plain"]["stream"],
        "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"],
        "device_ms": k["kernel"]["device"],
        "plain_device_ms": k["plain"]["device"],
        "shapes": {f"{name} F={F}": {"device_ms": v["kernel"]["device"], "plain_device_ms": v["plain"]["device"],
                                     "bound_ms": v["bound_ms"]} for (name, F), v in fk_times.items()},
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": 1}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-worker"]:
        sys.exit(dist_worker(sys.argv[2]))
    sys.exit(main())
