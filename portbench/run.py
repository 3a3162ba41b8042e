#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port, one run of one cell:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number the check compared, with its
limit (also the last lines of standard error). Exits non-zero without a
result when there is no card or too few, or when JAX or the JAX package is
loaded once the window has closed. See portbench/README.md.

``--control`` runs the check's control in the program's place (the
reference FK in bfloat16), ``--fault`` plants one of ``harness/faults.py``'s
faults under the timed path (both skip the warm call: they are read for
the check's limits), and ``--rank-spec`` is one rank of a four-card cell;
none is for measuring.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.harness import env  # noqa: E402

START = env.epoch_of_process_start()


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault")
    p.add_argument("--rank-spec")
    return p.parse_args(argv)


def emit(result: dict, checks: dict, out=None) -> None:
    """The check's numbers on standard error, then the result line, its
    ``checks`` key last."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(dict(result, checks=checks)), file=out or sys.stdout, flush=True)


def guard() -> None:
    found = env.forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {found}", file=sys.stderr)
        raise SystemExit(3)


def run_cell(cell, seed: int, seconds: float, trace: int, control: bool = False, device: str = "cuda:0",
             warm: bool = True, start: float = START, group=None, **job_kw):
    """Set-up, window or traced stretch, check: (result without checks,
    checks). ``group`` is ``harness/ranks.py::Group`` on one rank of
    several (rank 0 traces and judges; the others return (None, None)), and
    ``start`` the epoch ``setup_s`` counts from."""
    from portbench.harness import measure

    group = group or measure.Solo()
    job = cell.job_module().Job(cell, seed, device, control=control, **job_kw)
    t_made = time.time()
    if warm:
        job.call(0)  # the cell's shapes, warmed
    job.start_window()
    measure.sync(device)
    group.barrier()
    setup_s = time.time() - start
    print(f"portbench: set-up {setup_s:.2f} s (inputs ready at {t_made - start:.2f} s)", file=sys.stderr)
    if trace and group.rank == 0:
        solve = cell.traffic.get("trace_solve")
        records, ctx, failures = measure.traced(job, int(cell.traffic.get("trace_calls", 0)), f"{cell.name}-{seed}",
                                                solve=solve)
    elif trace:  # another rank: the same calls, untraced
        records, failures = [job.call(i) for i in range(int(cell.traffic["trace_calls"]) + 1)], []
    else:
        records, wall, failures = measure.closed_loop(job, seconds, start=1, group=group)
    peak = group.peak(measure.peak_bytes(device))
    group.close()
    if group.rank != 0:
        return None, None
    if trace:
        metrics = measure.per_layer(cell, ctx)
    t_ref = time.time()
    e2e, ok, checks, bad = measure.evaluate(job, records, cell.limits)
    if trace:
        extra = {"device": {"memory_peak_bytes": peak, "busy_s": ctx.trace.busy_us() * 1e-6,
                            "window_s": ctx.window_s},
                 "breakdown": {"device_ops": ctx.trace.top_ops(), "idle_gaps": ctx.trace.idle_by_host()}}
    else:
        rates = job.rates(len(records), wall)
        print(f"portbench: window {wall:.3f} s, {len(records)} calls; reference {time.time() - t_ref:.2f} s; "
              f"rates {json.dumps(rates)}", file=sys.stderr)
        readings = dict(e2e, setup_s=setup_s, **rates)
        metrics = {m["name"]: {"value": readings[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in readings}
        extra = {"device": {"memory_peak_bytes": peak}}
    for f in failures:
        print(f"portbench: failed {f}", file=sys.stderr)
    result = {"correct": bool(ok and not failures and not bad), "attempted": len(records) + len(failures),
              "failed": len(failures) + bad, "metrics": metrics, **extra}
    return result, checks


def run_as_asked(args, cell, **kw):
    """``run_cell`` with the run's arguments, under its ``--fault`` if one
    is planted; then the guard (a rank that fails it exits, and so fails
    the run)."""
    with contextlib.ExitStack() as stack:
        if args.fault:
            from portbench.harness.faults import planted

            stack.enter_context(planted(args.fault))
        out = run_cell(cell, args.seed, args.seconds, args.trace, args.control,
                       warm=not (args.control or args.fault), **kw)
    guard()
    return out


def run_one(args, cell, device_fields: dict, **kw) -> int:
    result, checks = run_as_asked(args, cell, **kw)
    result["device"] = dict(device_fields, **result["device"])
    emit(result, checks)
    return 0


def main(argv=None) -> int:
    args = parse(argv)
    env.set_cache_dirs()
    import torch

    import stac_mjx_tpu_torch  # noqa: F401  (the program under test, beside portbench/)

    from portbench.harness import spec

    if args.rank_spec:
        from portbench.harness import ranks

        return ranks.worker(args)
    cell = spec.Cell(args.workload)
    device_fields = env.card(torch, cell.chips)
    print(f"portbench: {cell.name} seed {args.seed} on {env.power_limit() or device_fields['kind']}",
          file=sys.stderr)
    if cell.chips > 1:
        from portbench.harness import ranks

        return ranks.parent(args, cell, device_fields, START)
    return run_one(args, cell, device_fields)


if __name__ == "__main__":
    sys.exit(main())
