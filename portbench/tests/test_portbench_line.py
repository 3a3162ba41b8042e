"""A whole run on the CPU at a small size, past the look for a card: the
result line's keys, and the check's numbers on standard error."""

from __future__ import annotations

import io
import json
import subprocess
import sys
from contextlib import redirect_stderr

import pytest

from portbench import run
from portbench.harness.env import ROOT
from portbench.tests.conftest import small_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(trace):
    cell = small_cell("critter-lm.fit")
    result, checks = run.run_cell(cell, 2**31 + 7, 0.5, trace, device="cpu")
    out, err = io.StringIO(), io.StringIO()
    with redirect_stderr(err):
        run.emit(result, checks, out=out)
    line = json.loads(out.getvalue().splitlines()[-1])
    assert list(line)[: len(KEYS)] == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    want = [m["name"] for m in (cell.per_layer if trace else cell.end_to_end)]
    if trace:  # no device events on the CPU: the readers that need them say nothing
        assert set(line["metrics"]) <= set(want)
        assert {"busy_s", "window_s"} <= set(line["device"]) and "breakdown" in line
    else:
        assert set(line["metrics"]) == set(want)
        assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert set(line["checks"]) == set(cell.limits)
    tail = err.getvalue().strip().splitlines()[-len(checks):]
    assert all(t.startswith("check ") and "(limit " in t for t in tail)


def test_no_card_no_result():
    proc = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"), "--workload", "critter-lm.fit",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300, env={"CUDA_VISIBLE_DEVICES": "", "PATH": ""})
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_without_the_program_it_fails(tmp_path):
    """A directory holding only BENCHMARK.json and portbench/ runs nothing."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, str(tmp_path / "portbench" / "run.py"), "--workload", "critter-lm.fit",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "No module named 'stac_mjx_tpu_torch'" in proc.stderr
