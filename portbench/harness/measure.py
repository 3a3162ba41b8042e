"""A run of one cell in one process: set-up, then either the measured window
(``--trace 0``: the end-to-end metrics) or a traced stretch (``--trace 1``:
the per-layer metrics), then the check, then the result line."""

from __future__ import annotations

import shutil
import time

import torch

from portbench.harness import check as check_mod
from portbench.harness import spec, trace


class Context:
    """What a per-layer reader reads (see ``portbench/metrics``)."""

    def __init__(self, tr: trace.Trace, counts: dict, job, calls: int, peak_bytes: int):
        self.trace = tr
        self.counts = counts
        self.calls = calls
        self.fits = calls * job.fits_per_call
        self.frames_per_call = job.frames_per_call
        self.window_s = tr.window_us * 1e-6
        self.peak_bytes = peak_bytes
        m = job.model
        self.dims = {"m": 3 * m.n_keypoints, "n": int(m.arrays["nv"]), "bodies": m.nbody - 1,
                     "joints": len(m.jnt_type), "sites": m.n_keypoints}

    def spans_within(self, name: str) -> list:
        """The (start, end) of each span of that name inside the window."""
        lo, hi = self.trace.window
        return [(s, e) for s, e in self.trace.spans.get(name, []) if s >= lo and e <= hi]

    def spans_in_window(self, name: str) -> int:
        return len(self.spans_within(name))

    def launched_in(self, span: str, cats=trace.DEVICE_CATS) -> list:
        lo, hi = self.trace.window
        return [d for d in self.trace.launched_in(span, cats) if d[2] < hi and d[3] > lo and d[4] >= lo]

    @staticmethod
    def device_us(events) -> float:
        return sum(d[3] - d[2] for d in events)


def sync(device) -> None:
    if str(device).startswith("cuda"):
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    """The most memory the process's tensors held on the card."""
    return int(torch.cuda.max_memory_allocated(device)) if str(device).startswith("cuda") else 0


class Solo:
    """The processes of a run, when it is one: its own clock ends the window.
    ``harness/ranks.py::Group`` is the same for one process per card."""

    rank = 0

    def barrier(self) -> None:
        pass

    def go_on(self, elapsed: float, seconds: float) -> bool:
        return elapsed < seconds

    def peak(self, nbytes: int) -> int:
        return nbytes

    def close(self) -> None:
        pass


def closed_loop(job, seconds: float, start: int = 0, group=None):
    """Whole jobs one after another until ``seconds`` have passed (by the
    ``group``'s clock); a job that starts inside the window finishes and
    counts. Returns (records, wall s, failures)."""
    group = group or Solo()
    records, failures, i = [], [], start
    t0 = time.perf_counter()
    while True:
        try:
            records.append(job.call(i))
        except Exception as e:  # a job that raises counts in failed
            failures.append(f"call {i}: {type(e).__name__}: {e}")
        i += 1
        if not group.go_on(time.perf_counter() - t0, seconds):
            return records, time.perf_counter() - t0, failures


def traced(job, calls: int, tag: str, solve: int | None = None):
    """The traced stretch, under the per-layer spans: one lead-in call (the
    profiler misses what comes right after its start), then ``calls`` whole
    calls in the span ``pb.window``. With ``solve``, one call whose
    ``solve``-th projected-gradient solve alone is the window (a PG call
    runs millions of kernels), the profiler started as the solve before it
    ends. Returns (records, Context, failures)."""
    device = job.device
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    path = trace.trace_path(tag)
    records, failures, state = [], [], {}
    cuda = device.type == "cuda"

    def run(i):
        try:
            records.append(job.call(i))
        except Exception as e:  # a job that raises counts in failed
            failures.append(f"call {i}: {type(e).__name__}: {e}")

    with trace.Instrument(torch) as ins:
        if solve is None:
            prof = trace.start(torch, cuda=cuda)
            try:
                run(0)
                ins.active = True
                with trace.window_span(torch):
                    for i in range(1, calls + 1):
                        run(i)
                    sync(device)
            finally:
                ins.active = False
                trace.stop(prof, path)
        else:
            def hook(i, when):
                if i == solve - 1 and when == "after":
                    state["prof"] = trace.start(torch, cuda=cuda)
                elif i == solve and when == "before":
                    state["span"] = trace.window_span(torch)
                    state["span"].__enter__()
                    ins.active = True
                elif i == solve and when == "after":
                    sync(device)
                    state["span"].__exit__(None, None, None)
                    ins.active = False
                    trace.stop(state.pop("prof"), path)

            ins.pg_hook = hook
            run(1)
            calls = 0
    tr = trace.Trace.load(path)
    shutil.rmtree(path.parent, ignore_errors=True)
    return records, Context(tr, ins.counts, job, calls, peak_bytes(device)), failures


def per_layer(cell: spec.Cell, ctx: Context) -> dict:
    out = {}
    for m in cell.per_layer:
        v = spec.metric_reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def evaluate(job, records, limits: dict):
    """Runs the reference over every output (after the program's state is
    freed) and judges the numbers: (e2e readings, correct, checks, the
    count of calls whose own numbers fail)."""
    job.release()
    res = job.evaluate(records)
    ok, checks = check_mod.judge(res["numbers"], limits)
    bad = sum(not check_mod.judge({k: v for k, v in n.items() if k in limits},
                                  {k: limits[k] for k in n if k in limits})[0] for n in res["per_call"])
    return res["e2e"], ok, checks, bad
