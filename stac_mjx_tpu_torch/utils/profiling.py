"""Phase timers, spans and device traces (port of ``stac_mjx_tpu/utils/profiling.py``).

- ``phase(name)``: times a pipeline phase; durations accumulate in a
  process-wide registry (``report()`` summarises, ``reset()`` clears) and are
  logged through the package logger; the phase is also a span. ``Stac``
  wraps its four entry points in it.
- ``annotate(name)``: a named span (``torch.profiler.record_function``) while
  a torch profiler records, else a shared no-op. The program opens spans
  where its work happens (``stac.upload``, ``stac.solve``, ``stac.fetch``,
  ``stac.package``, ``lm.solve``, ``lm.capture``, ``lm.replay``,
  ``lm.iter``, ``lm.jacobian``, ``fk``, ``pg.iter``, ``pg.capture``,
  ``pg.replay``, ``lanes.sync``, ``dist.all_gather``; see
  PERF.md). They appear in any ``torch.profiler`` trace, ``device_trace``'s
  included, on the timeline of the card's kernels; with no profiler a span
  costs one test of the profiler's flag (~0.1 us), records nothing and
  never syncs, allocates or launches.
- ``device_trace(logdir)``: ``torch.profiler`` over the enclosed block (CPU
  activity, and CUDA where a card is present), exported as a Chrome trace
  under ``logdir``; warns and carries on when the profiler cannot start.
- ``op_table(logdir)``: time per kernel (or per CPU op) summed from the
  newest trace under ``logdir``.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import logging
import os
import time
from collections import defaultdict

import torch

logger = logging.getLogger("stac_mjx_tpu_torch")

_phase_totals: dict[str, float] = defaultdict(float)
_phase_counts: dict[str, int] = defaultdict(int)
_NO_SPAN = contextlib.nullcontext()


def annotate(name: str):
    """A span named ``name`` in the trace of the torch profiler that is
    recording, or, with none recording, one shared no-op context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def phase(name: str, log: bool = True):
    """Time a pipeline phase, as a span of the same name; accumulate into
    the process-wide registry."""
    t0 = time.perf_counter()
    try:
        with annotate(name):
            yield
    finally:
        dt = time.perf_counter() - t0
        _phase_totals[name] += dt
        _phase_counts[name] += 1
        if log:
            logger.info("phase %s: %.3fs", name, dt)


def report() -> dict[str, dict[str, float]]:
    """Snapshot of accumulated phase timings: {name: {total_s, count}}."""
    return {
        name: {"total_s": _phase_totals[name], "count": _phase_counts[name]}
        for name in _phase_totals
    }


def reset() -> None:
    """Clear the phase-timing registry."""
    _phase_totals.clear()
    _phase_counts.clear()


@contextlib.contextmanager
def device_trace(logdir: str):
    """Trace the enclosed block with torch.profiler and write it as
    ``<logdir>/trace_<time ns>.pt.trace.json`` (chrome://tracing, Perfetto).

    The block's device work is synchronised before the trace stops. When the
    profiler cannot start, it warns and runs the block untraced.
    """
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    try:
        prof.start()
    except RuntimeError as e:  # the profiler is unavailable in this process
        logger.warning("device_trace unavailable: %s", e)
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.stop()
            os.makedirs(logdir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(logdir, f"trace_{time.time_ns()}.pt.trace.json"))


def op_table(logdir: str, device_substr: str = "GPU", top: int = 12) -> dict:
    """Time per op from the newest ``device_trace`` under ``logdir``.

    Sums the durations of the trace's complete events of category ``kernel``
    (the card's kernels, by kernel name) or, with ``device_substr="CPU"``,
    ``cpu_op`` (the host's aten ops). Returns {"total_op_us", "ops": [{op,
    us, pct, count, category}, ...] (the ``top`` longest), "copy_formatting_pct"
    (memcpy and memset time, in % of kernel plus copy time; 0 for the CPU)};
    an empty ops list if there is no trace or no such event.
    """
    paths = glob.glob(os.path.join(logdir, "**", "*.pt.trace.json*"), recursive=True)
    if not paths:
        return {"total_op_us": 0.0, "ops": [], "copy_formatting_pct": 0.0}
    path = max(paths, key=os.path.getmtime)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        events = json.load(fh).get("traceEvents", [])
    category = "cpu_op" if device_substr.upper() == "CPU" else "kernel"
    durs: dict[str, float] = collections.Counter()
    counts: dict[str, int] = collections.Counter()
    copy_us = 0.0
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat == category:
            durs[e.get("name", "")] += e.get("dur", 0)
            counts[e.get("name", "")] += 1
        elif category == "kernel" and cat in ("gpu_memcpy", "gpu_memset"):
            copy_us += e.get("dur", 0)
    total = sum(durs.values())
    if not total:
        return {"total_op_us": 0.0, "ops": [], "copy_formatting_pct": 0.0}
    return {
        "total_op_us": round(total, 1),
        "ops": [
            {"op": name, "us": round(d, 1), "pct": round(100 * d / total, 1), "count": counts[name],
             "category": category}
            for name, d in collections.Counter(durs).most_common(top)
        ],
        "copy_formatting_pct": round(100 * copy_us / (total + copy_us), 1),
    }
