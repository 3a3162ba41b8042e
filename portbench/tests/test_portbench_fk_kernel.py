"""The reader of the FK kernel's spans on canned traces: the share of FK
passes that launched the kernel, only inside the window, and nothing read
where the kernel's spans are absent (the parent's program, which opens
``fk`` spans only)."""

from __future__ import annotations

import pytest

from portbench.harness import trace
from portbench.tests.test_portbench_spans import _ctx, _device, _read, _span

NAME = "fk.kernel_pct.ik"


def _fk_trace(kernel_passes=(0, 1, 2)):
    """Window 0-100 us; three FK passes (5-15, 35-45, 65-75), those listed
    with an ``fk.kernel`` span and a kernel launched inside; a fourth pass
    with its kernel span after the window."""
    passes = [(5, 15), (35, 45), (65, 75)]
    ev = [_span(trace.WINDOW, 0, 100), _span("fk", 110, 120), _span("fk.kernel", 111, 119)]
    for i, (s, e) in enumerate(passes):
        ev.append(_span("fk", s, e))
        if i in kernel_passes:
            ev.append(_span("fk.kernel", s + 1, e - 1))
            ev += _device("fk_jump_kernel", "kernel", s + 3, s + 8, i + 1, s + 2)
    return trace.Trace(ev)


@pytest.mark.parametrize("kernel_passes,want", [((0, 1, 2), 100.0), ((0, 2), 200.0 / 3), ((1,), 100.0 / 3)])
def test_share_of_passes_in_the_kernel(kernel_passes, want):
    assert _read(NAME, _ctx(_fk_trace(kernel_passes))) == pytest.approx(want)


def test_no_kernel_spans_no_reading():
    """The parent's trace (fk spans, no fk.kernel) and a trace without FK
    read nothing; fk.device_ms still reads the kernel launched in fk."""
    assert _read(NAME, _ctx(_fk_trace(kernel_passes=()))) is None
    assert _read(NAME, _ctx(trace.Trace([_span(trace.WINDOW, 0, 100)]))) is None
    assert _read("fk.device_ms", _ctx(_fk_trace(), calls=3)) == pytest.approx(5e-3)
