"""Spans and counters put around calls into the program from outside, the
traced stretch, and its reduction to what the per-layer readers read.

``Instrument`` wraps functions of the program (module attributes, restored
on exit) in ``torch.profiler.record_function`` spans named ``pb.<what>``,
and counts on the host what each call hands in: the size of every SPD solve
(F, n), the iterations of every projected-gradient solve (its slowest
lane's). ``start``/``stop`` profile a stretch of whole calls, marked by a
span ``pb.window``, and write the Chrome trace, gzipped; ``Trace`` reads it back:
device intervals (kernels, copies, memsets) with the host time of their
launch, host spans, and the innermost host op at any instant.
"""

from __future__ import annotations

import bisect
import gzip
import importlib
import json
from pathlib import Path

from portbench.harness.env import scratch_dir

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "pb.window"

# (module, attribute path, span name): the calls the per-layer metrics read.
SPANS = (
    ("stac_mjx_tpu_torch.stac", "Stac.ik_only", "pb.entry"),
    ("stac_mjx_tpu_torch.stac", "Stac.fit_offsets", "pb.entry"),
    ("stac_mjx_tpu_torch.stac", "Stac.fit_offsets_sharded", "pb.fit_sharded"),
    ("stac_mjx_tpu_torch.stac", "Stac.ik_only_global", "pb.ik_global"),
    ("stac_mjx_tpu_torch.ops.gn_ik", "spd_solve", "pb.spd"),
    ("stac_mjx_tpu_torch.ops.stac_core", "m_opt_closed_form", "pb.mphase"),
    ("stac_mjx_tpu_torch.ops.solver", "ProjectedGradient.run", "pb.pg"),
)


class Instrument:
    """Context manager installing the SPANS; ``counts`` holds what they
    counted while ``active``, call by call: "spd" [(F, n)], "pg"
    [iterations]. ``pg_hook(i, "before" | "after")``, when set, runs around
    the i-th projected-gradient solve since entry."""

    def __init__(self, torch):
        self.torch = torch
        self.counts = {"spd": [], "pg": []}
        self.active = False
        self.pg_hook = None
        self._pg_seen = 0
        self._undo = []

    def _wrap(self, name, fn):
        record = self.torch.profiler.record_function
        counts = self.counts

        def wrapped(*args, **kwargs):
            i = None
            if name == "pb.pg":
                i, self._pg_seen = self._pg_seen, self._pg_seen + 1
                if self.pg_hook:
                    self.pg_hook(i, "before")
            with record(name):
                out = fn(*args, **kwargs)
            if name == "pb.spd" and self.active:
                g = args[1]
                counts["spd"].append((int(g.shape[0]), int(g.shape[1])))
            elif name == "pb.pg":
                if self.active:
                    counts["pg"].append(int(out.iters.max()))
                if self.pg_hook:
                    self.pg_hook(i, "after")
            return out

        return wrapped

    def __enter__(self):
        for mod_name, path, span in SPANS:
            owner = importlib.import_module(mod_name)
            *outer, attr = path.split(".")
            for part in outer:
                owner = getattr(owner, part)
            orig = owner.__dict__[attr]
            setattr(owner, attr, self._wrap(span, orig))
            self._undo.append((owner, attr, orig))
        return self

    def __exit__(self, *exc):
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo.clear()


def trace_path(tag: str) -> Path:
    """Where a traced run writes its trace: a directory of the run's own
    (``env.scratch_dir``)."""
    return scratch_dir("portbench-trace-") / f"{tag}.pt.trace.json.gz"


def start(torch, cuda: bool = True):
    """A started torch.profiler over the host's ops and the card's."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def window_span(torch):
    """The span that marks the traced window."""
    return torch.profiler.record_function(WINDOW)


def stop(prof, path: Path) -> None:
    """Stops the profiler and writes its trace to ``path``, gzipped."""
    prof.stop()
    raw = path.with_suffix("")  # .json
    prof.export_chrome_trace(str(raw))
    with open(raw, "rb") as src, gzip.open(path, "wb", compresslevel=3) as dst:
        dst.write(src.read())
    raw.unlink()


def union_s(intervals, lo: float, hi: float) -> float:
    """Length of the union of (start, end) intervals clipped to [lo, hi],
    in the intervals' unit."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


class Trace:
    """A Chrome trace of torch.profiler reduced to lists (times in us)."""

    def __init__(self, events: list[dict]):
        launch_ts, self.spans, host = {}, {}, []
        dev = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, args = e.get("cat", ""), e.get("args") or {}
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            if cat in DEVICE_CATS:
                dev.append((e.get("name", ""), cat, ts, ts + dur, args.get("correlation")))
            elif cat in LAUNCH_CATS:
                if "correlation" in args:
                    launch_ts[args["correlation"]] = ts
                host.append((ts, ts + dur, e.get("name", ""), e.get("tid")))
            elif cat == "user_annotation":
                self.spans.setdefault(e["name"], []).append((ts, ts + dur))
                host.append((ts, ts + dur, e.get("name", ""), e.get("tid")))
            elif cat == "cpu_op":
                host.append((ts, ts + dur, e.get("name", ""), e.get("tid")))
        # (name, category, start, end, host time of the launch or None)
        self.device = [(n, c, s, t, launch_ts.get(k)) for n, c, s, t, k in dev]
        windows = self.spans.get(WINDOW) or []
        self.window = windows[0] if windows else (
            (min(d[2] for d in self.device), max(d[3] for d in self.device)) if self.device else (0.0, 0.0))
        tids = [tid for s, e, n, tid in host if n == WINDOW]
        self._host = sorted((h for h in host if not tids or h[3] == tids[0]), key=lambda h: (h[0], -h[1]))

    @classmethod
    def load(cls, path: Path) -> "Trace":
        opener = gzip.open if str(path).endswith(".gz") else open
        with opener(path, "rt") as fh:
            return cls(json.load(fh).get("traceEvents", []))

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def in_window(self, cats=DEVICE_CATS) -> list:
        lo, hi = self.window
        return [d for d in self.device if d[1] in cats and d[3] > lo and d[2] < hi]

    def busy_us(self) -> float:
        """Time in the window when a kernel, copy or memset ran (a union)."""
        return union_s([(d[2], d[3]) for d in self.in_window()], *self.window)

    def launched_in(self, span: str, cats=DEVICE_CATS) -> list:
        """Device events launched from inside any span of that name."""
        spans = sorted(self.spans.get(span) or [])
        starts = [s for s, _ in spans]
        out = []
        for d in self.device:
            if d[1] not in cats or d[4] is None:
                continue
            i = bisect.bisect_right(starts, d[4]) - 1
            if i >= 0 and d[4] <= spans[i][1]:
                out.append(d)
        return out

    def top_ops(self, n: int = 10) -> list:
        """[[name, seconds]] of the device ops in the window, longest total first."""
        tot = {}
        for name, _, s, e, _ in self.in_window():
            tot[name] = tot.get(name, 0.0) + (e - s)
        return [[k, v * 1e-6] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def _innermost(self):
        """Segments (start, end, name) of the innermost host op or span on
        the window's thread."""
        segs, stack, t = [], [], None
        for s, e, name, _ in self._host:
            while stack and stack[-1][1] <= s:
                top = stack.pop()
                if t < top[1]:
                    segs.append((t, top[1], top[2]))
                    t = top[1]
            if stack and t < s:
                segs.append((t, s, stack[-1][2]))
            stack.append((s, e, name))
            t = s
        while stack:
            top = stack.pop()
            if t < top[1]:
                segs.append((t, top[1], top[2]))
                t = top[1]
        return segs

    def idle_by_host(self, n: int = 10) -> list:
        """[[host op, seconds]]: the window's idle device time by the
        innermost host op or span at the middle of each idle gap, longest
        total first."""
        busy = [(d[2], d[3]) for d in self.in_window()]
        segs = self._innermost()
        starts = [s for s, _, _ in segs]
        tot = {}
        for s, e in gaps(busy, *self.window):
            mid = 0.5 * (s + e)
            i = bisect.bisect_right(starts, mid) - 1
            name = segs[i][2] if i >= 0 and mid < segs[i][1] else "(no host op)"
            tot[name] = tot.get(name, 0.0) + (e - s)
        return [[k, v * 1e-6] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]
