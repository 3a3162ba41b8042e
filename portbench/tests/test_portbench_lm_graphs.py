"""The readers of the LM's graph spans on canned traces: the share of solves
that replayed a graph, the device's idle time inside the solves per fit,
and nothing read where the spans are absent (the parent's program, which
opens no ``lm.solve``)."""

from __future__ import annotations

import pytest

from portbench.harness import trace
from portbench.tests.test_portbench_spans import _ctx, _device, _read, _span

NEW = ("lm.graph_hit_pct.fit", "lm.graph_hit_pct.ik", "lm.solve_idle_ms.fit")


def _solves_trace(replays=True):
    """Window 0-100 us, busy 10-20, 40-50 (kernels) and 70-80 (a copy); idle
    0-10, 20-40, 50-70, 80-100. Three solves: 2-30 eager (its lm.iter spans
    inside), 32-60 captured then replayed, 62-90 replayed; a fourth, a
    replay, after the window."""
    ev = [_span(trace.WINDOW, 0, 100), _span("lm.solve", 2, 30), _span("lm.iter", 3, 15),
          _span("lm.iter", 16, 29), _span("lm.solve", 32, 60), _span("lm.capture", 33, 40),
          _span("lm.solve", 62, 90), _span("lm.solve", 110, 120)]
    if replays:
        ev += [_span("lm.replay", 41, 59), _span("lm.replay", 63, 89), _span("lm.replay", 111, 119)]
    ev += _device("A", "kernel", 10, 20, 1, 5) + _device("B", "kernel", 40, 50, 2, 41)
    ev += _device("Memcpy DtoH", "gpu_memcpy", 70, 80, 3, 65)
    return trace.Trace(ev)


@pytest.mark.parametrize("suffix", ["fit", "ik"])
def test_graph_hit_share(suffix):
    assert _read(f"lm.graph_hit_pct.{suffix}", _ctx(_solves_trace())) == pytest.approx(100 * 2 / 3)
    assert _read(f"lm.graph_hit_pct.{suffix}", _ctx(_solves_trace(replays=False))) == 0.0


@pytest.mark.parametrize("calls", [1, 2])
def test_solve_idle_per_fit(calls):
    # idle inside 2-30, 32-60, 62-90: 2-10, 20-30, 32-40, 50-60, 62-70, 80-90
    assert _read("lm.solve_idle_ms.fit", _ctx(_solves_trace(), calls=calls)) == pytest.approx(54e-3 / calls)


def test_no_spans_no_readings():
    """The parent's trace (no lm.solve) reads nothing; without a device
    event (the CPU) the idle reads nothing, the hit share still reads."""
    parent = _solves_trace()
    parent.spans = {k: v for k, v in parent.spans.items() if not k.startswith("lm.")}
    for name in NEW:
        assert _read(name, _ctx(parent)) is None, name
    host_only = trace.Trace([_span(trace.WINDOW, 0, 100), _span("lm.solve", 2, 30), _span("lm.replay", 3, 29)])
    assert _read("lm.solve_idle_ms.fit", _ctx(host_only)) is None
    assert _read("lm.graph_hit_pct.fit", _ctx(host_only)) == 100.0
