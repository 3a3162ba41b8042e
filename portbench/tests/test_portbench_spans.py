"""The readers of the program's own spans, on canned traces: idle time by
interval intersection (a gap that straddles two spans counts only where it
lies inside them), device time by launch, host time in spans, and nothing
read where the spans are absent."""

from __future__ import annotations

import pytest

from portbench.harness import spans as sp
from portbench.harness import spec, trace
from portbench.harness.measure import Context
from portbench.tests.test_portbench_trace import _Job

NEW = ("lm.idle_us_per_iter.fit", "lm.idle_us_per_iter.ik", "lm.device_us_per_iter.fit",
       "lm.device_us_per_iter.ik", "fk.device_ms", "jac.device_ms", "pg.launch_ms_per_iter",
       "pg.sync_ms_per_iter", "pg.capture_ms", "stac.idle_ms", "dist.gather_ms")


def _span(name, ts, end):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": end - ts, "tid": 1}


def _device(name, cat, ts, end, corr, launched):
    return [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": launched, "dur": 0.5, "tid": 1,
             "args": {"correlation": corr}},
            {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": end - ts, "args": {"correlation": corr}}]


def _lm_trace():
    """Window 0-100 us, busy 10-20 (kernel A, launched at 5 in lm.jacobian),
    40-50 (kernel B, launched at 38 in fk) and 70-80 (a copy launched at 65
    in stac.fetch); idle 0-10, 20-40, 50-70, 80-100. Two lm.iter spans,
    2-30 and 32-60: the gap 20-40 straddles both and the hole between them."""
    ev = [_span(trace.WINDOW, 0, 100), _span("lm.iter", 2, 30), _span("lm.iter", 32, 60),
          _span("lm.jacobian", 3, 8), _span("lm.jacobian", 33, 36), _span("fk", 37, 45),
          _span("stac.upload", 0, 2), _span("stac.fetch", 62, 90), _span("stac.package", 90, 99),
          _span("lm.iter", 120, 130)]  # after the window
    ev += _device("A", "kernel", 10, 20, 1, 5) + _device("B", "kernel", 40, 50, 2, 38)
    ev += _device("Memcpy DtoH", "gpu_memcpy", 70, 80, 3, 65)
    return trace.Trace(ev)


def _ctx(tr, calls=1):
    return Context(tr, {"spd": [], "pg": []}, _Job(), calls, 0)


def _read(name, ctx):
    return spec.metric_reader(name)(ctx)


def test_interval_helpers():
    assert sp.merged([(5, 8), (0, 2), (1, 3), (8, 9)]) == [(0, 3), (5, 9)]
    assert sp.overlap_us([(0, 10), (20, 40)], [(5, 25), (30, 31)]) == 5 + 5 + 1
    assert sp.overlap_us([], [(0, 1)]) == 0


@pytest.mark.parametrize("suffix", ["fit", "ik"])
def test_lm_idle_by_intersection_and_device_time(suffix):
    ctx = _ctx(_lm_trace())
    # idle inside 2-30 and 32-60: 2-10, 20-30, 32-40, 50-60 = 36 us over 2 iterations
    assert _read(f"lm.idle_us_per_iter.{suffix}", ctx) == pytest.approx(18.0)
    # kernels A and B were launched inside lm.iter spans: 20 us over 2 iterations
    assert _read(f"lm.device_us_per_iter.{suffix}", ctx) == pytest.approx(10.0)


def test_layer_device_time_by_launch():
    ctx = _ctx(_lm_trace(), calls=2)
    assert _read("jac.device_ms", ctx) == pytest.approx(10e-3 / 2)
    assert _read("fk.device_ms", ctx) == pytest.approx(10e-3 / 2)


def test_entry_idle_inside_its_host_work():
    ctx = _ctx(_lm_trace())
    # spans 0-2, 62-90, 90-99 against the idle 0-10, 50-70, 80-100: 2 + 8 + 19
    assert _read("stac.idle_ms", ctx) == pytest.approx(29e-3)
    window_idle = ctx.trace.window_us - ctx.trace.busy_us()
    every = ("lm.iter", "lm.jacobian", "fk", "stac.upload", "stac.fetch", "stac.package")
    assert sp.idle_us(ctx, every) <= window_idle


def test_pg_host_times():
    ev = [_span(trace.WINDOW, 0, 100), _span("pb.pg", 1, 99), _span("pg.capture", 2, 20),
          _span("pg.iter", 20, 50), _span("pg.iter", 50, 80), _span("pg.replay", 22, 30),
          _span("pg.replay", 52, 58), _span("lanes.sync", 31, 33), _span("lanes.sync", 60, 61),
          _span("lanes.sync", 85, 90), _span("pg.replay", 110, 120)]
    ctx = _ctx(trace.Trace(ev))
    assert _read("pg.launch_ms_per_iter", ctx) == pytest.approx((8 + 6) * 1e-3 / 2)
    assert _read("pg.sync_ms_per_iter", ctx) == pytest.approx((2 + 1 + 5) * 1e-3 / 2)
    assert _read("pg.capture_ms", ctx) == pytest.approx(18e-3)


def test_gather_host_time_per_job():
    ev = [_span(trace.WINDOW, 0, 100), _span("dist.all_gather", 10, 20), _span("dist.all_gather", 30, 35),
          _span("dist.all_gather", 140, 150)]
    assert _read("dist.gather_ms", _ctx(trace.Trace(ev), calls=2)) == pytest.approx(7.5e-3)


def test_no_spans_no_readings():
    """The parent's trace (the pb.* spans only) and a trace of spans without
    a device event (the CPU): each new reader returns None, but the host
    times, which need no device event."""
    parent = _lm_trace()
    parent.spans = {k: v for k, v in parent.spans.items() if k == trace.WINDOW}
    for name in NEW:
        assert _read(name, _ctx(parent)) is None, name
    host_only = trace.Trace([_span(trace.WINDOW, 0, 100), _span("lm.iter", 2, 30), _span("stac.fetch", 40, 50)])
    for name in ("lm.idle_us_per_iter.fit", "lm.device_us_per_iter.ik", "stac.idle_ms", "fk.device_ms"):
        assert _read(name, _ctx(host_only)) is None, name
