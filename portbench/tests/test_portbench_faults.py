"""The check catches what it is there to catch: a run on the CPU at a small
size with the timed path broken underneath (``harness.faults``), or with
the control in the program's place, comes out not correct; the same run
unbroken comes out correct."""

from __future__ import annotations

import argparse
import io
import json
import sys
from contextlib import redirect_stdout

import pytest

from portbench import run
from portbench.harness import env, ranks
from portbench.harness.faults import PLANTED_JAX, planted
from portbench.tests.conftest import small_cell

SEED = 4_000_000_123


def _run(name, fault=None, control=False, **model):
    cell = small_cell(name, **model)
    if fault is None:
        return run.run_cell(cell, SEED, 0.1, 0, control=control, device="cpu")
    with planted(fault):
        return run.run_cell(cell, SEED, 0.1, 0, control=control, device="cpu")


@pytest.mark.parametrize("name", ["critter-lm.ik-session", "critter-lm.fit"])
def test_sound_runs_are_correct(name):
    result, checks = _run(name)
    assert result["correct"], checks


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", ["critter-lm.ik-session", "critter-lm.fit"])
def test_faults_are_caught(name, fault):
    result, checks = _run(name, fault)
    assert not result["correct"], checks
    assert result["failed"] >= 1


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_faults_are_caught_on_the_parity_path(fault):
    # A short PG budget keeps the CPU run short: a broken run fails whatever the budget.
    result, checks = _run("critter-pg.ik", fault, N_ITER_Q=30)
    assert not result["correct"], checks


@pytest.mark.parametrize("name", ["critter-lm.ik-session", "critter-lm.fit"])
def test_the_control_is_caught(name):
    result, checks = _run(name, control=True)
    assert not result["correct"], checks


def _two_ranks(trace=0, fault=None, control=False, rc=0):
    cell = small_cell("critter-lm.session-4card")
    args = argparse.Namespace(workload=cell.name, seed=SEED, seconds=0.1, trace=trace, control=control, fault=fault)
    extra = {"cpu": True,
             "traffic": {"fit_clips": 2, "clip_frames": 60, "clips": 4, "animals": 1, "trace_calls": 1}}
    out = io.StringIO()
    with redirect_stdout(out):
        got = ranks.parent(args, cell, {"platform": "cpu"}, env.epoch_of_process_start(), world=2, extra=extra)
    assert got == rc
    return json.loads(out.getvalue().strip().splitlines()[-1]) if rc == 0 else out.getvalue()


def test_two_ranks_sound_and_broken():
    """One sound two-rank run over gloo, then each fault of the exchange
    and the control: each must come out not correct."""
    assert _two_ranks()["correct"]
    for fault in ("no_gather", "no_allreduce"):
        line = _two_ranks(fault=fault)
        assert not line["correct"], (fault, line["checks"])
    assert not _two_ranks(control=True)["correct"]


def test_two_ranks_traced_read_the_sharded_entries():
    line = _two_ranks(trace=1)
    assert line["correct"]
    assert line["metrics"]["dist.ik_fps"]["value"] > 0 and line["metrics"]["dist.fit_s"]["value"] > 0


def test_a_rank_that_loads_jax_fails_the_run():
    """The last rank (not the one that judges and writes the result) loads
    a module named jax under the timed path: the run prints no result."""
    assert _two_ranks(fault="loads_jax", rc=1).strip() == ""


def test_one_process_that_loads_jax_prints_no_result():
    args = argparse.Namespace(workload="critter-lm.fit", seed=SEED, seconds=0.1, trace=0, control=False,
                              fault="loads_jax")
    out = io.StringIO()
    try:
        with redirect_stdout(out), pytest.raises(SystemExit) as ex:
            run.run_one(args, small_cell("critter-lm.fit"), {"platform": "cpu"}, device="cpu")
    finally:
        if getattr(sys.modules.get("jax"), "__doc__", None) == PLANTED_JAX:
            del sys.modules["jax"]
    assert ex.value.code not in (0, None) and out.getvalue() == ""


def test_an_m_phase_that_returns_its_offsets_is_caught():
    result, checks = _run("critter-lm.fit", "mphase_unchanged")
    assert not result["correct"] and checks["mphase_gap_mm"]["value"] > checks["mphase_gap_mm"]["limit"], checks
