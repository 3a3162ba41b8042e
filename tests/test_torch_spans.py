"""The port's spans (``profiling.annotate``): a shared no-op while no
profiler records, outputs bitwise the same with a profiler on, and under
``device_trace`` the spans where the work happens, in the counts the
per-layer metrics of ``portbench/`` rely on."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from _torch_common import THROUGHPUT, bridge, torch_stac
from stac_mjx_tpu_torch.models.firstparty import make_recording
from stac_mjx_tpu_torch.ops import gn_ik, solver
from stac_mjx_tpu_torch.utils import profiling

SMALL_IK = dict(THROUGHPUT, n_frames_per_clip=4)
SMALL_MODEL = {"N_ITERS": 1}
ENTRY_SPANS = ("stac.upload", "stac.solve", "stac.fetch", "stac.package")


def _spans(logdir) -> list[tuple[str, float, float]]:
    """(name, start us, end us) of every span in the newest trace under logdir."""
    path = max(glob.glob(os.path.join(str(logdir), "*.pt.trace.json")), key=os.path.getmtime)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return sorted((e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                  for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation")


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(spans, name, outer) -> list:
    """The spans of that name that start within the span ``outer``."""
    return [s for s in _named(spans, name) if outer[1] <= s[1] <= outer[2]]


@pytest.fixture(scope="module")
def keypoints():
    kp, _, _, _ = make_recording(bridge.load_bundle(), n_frames=8, seed=0, device="cpu")
    return kp


@pytest.mark.parametrize("name", ["fk", "lm.iter", "stac.upload"])
def test_annotate_without_a_profiler_is_the_shared_noop(name):
    span = profiling.annotate(name)
    assert span is profiling.annotate("another name")
    assert not isinstance(span, torch.profiler.record_function)
    with span, span:  # reusable and re-entrant
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert isinstance(profiling.annotate(name), torch.profiler.record_function)
    assert profiling.annotate(name) is span


def _entry_outputs(entry, kp, logdir=None):
    """qpos and the other arrays of one small call of ``entry`` (a fresh
    Stac), traced when ``logdir`` is given."""
    st = torch_stac(SMALL_IK, SMALL_MODEL)
    offsets = st._offsets.copy()
    trace = profiling.device_trace(str(logdir)) if logdir else None
    if trace:
        trace.__enter__()
    try:
        data = st.fit_offsets(kp) if entry == "fit_offsets" else st.ik_only(kp, offsets)
    finally:
        if trace:
            trace.__exit__(None, None, None)
    return {k: v for k, v in data.as_dict().items() if isinstance(v, np.ndarray)}


@pytest.mark.parametrize("entry", ["ik_only", "fit_offsets"])
def test_outputs_bitwise_the_same_traced(entry, keypoints, tmp_path):
    plain = _entry_outputs(entry, keypoints)
    traced = _entry_outputs(entry, keypoints, tmp_path)
    assert _named(_spans(tmp_path), entry), "the phase is a span of its name"
    assert plain.keys() == traced.keys()
    for k in plain:
        assert np.array_equal(plain[k], traced[k]), k


@pytest.fixture(scope="module")
def traced_ik(keypoints, tmp_path_factory):
    """The spans of one small ik_only under device_trace, and the spd_solve
    calls it made."""
    logdir = tmp_path_factory.mktemp("spans")
    st = torch_stac(SMALL_IK, SMALL_MODEL)
    calls = []
    orig = gn_ik.spd_solve

    def counting(*args, **kwargs):
        calls.append(1)
        return orig(*args, **kwargs)

    gn_ik.spd_solve = counting
    try:
        with profiling.device_trace(str(logdir)):
            st.ik_only(keypoints, st._offsets.copy())
    finally:
        gn_ik.spd_solve = orig
    return _spans(logdir), len(calls)


def test_one_lm_iter_span_per_spd_solve(traced_ik):
    spans, solves = traced_ik
    assert solves > 0 and len(_named(spans, "lm.iter")) == solves


@pytest.mark.parametrize("child,least,most", [("lm.jacobian", 1, 1), ("fk", 1, None)])
def test_each_lm_iter_holds_its_layers(traced_ik, child, least, most):
    spans, _ = traced_ik
    for it in _named(spans, "lm.iter"):
        n = len(_inside(spans, child, it))
        assert n >= least and (most is None or n <= most), (child, n)


@pytest.mark.parametrize("name", ENTRY_SPANS)
def test_entry_spans_nest_in_the_phase(traced_ik, name):
    spans, _ = traced_ik
    (phase,) = _named(spans, "ik_only")
    assert len(_named(spans, name)) == len(_inside(spans, name, phase)) >= 1
    assert all(s[2] <= phase[2] for s in _named(spans, name))


def test_pg_iter_and_lane_sync_spans(tmp_path):
    """A small projected-gradient solve over three lanes that stop at
    different iterations: one pg.iter span per iteration of the slowest
    lane, one lanes.sync span per condition the lanes' loops tested."""
    target = torch.tensor([[0.3, -0.2], [2.0, 1.0], [-0.5, 0.1]], dtype=torch.float64)
    scale = torch.tensor([[1.0, 4.0], [1.0, 1.0], [9.0, 1.0]], dtype=torch.float64)

    def fun(x):
        return torch.sum(scale * (x - target) ** 2, dim=-1)

    checks = []
    orig = solver.while_lanes

    def counting(cond, body, state):
        def counted(s):
            checks.append(1)
            return cond(s)

        return orig(counted, body, state)

    solver.while_lanes = counting
    try:
        with profiling.device_trace(str(tmp_path)):
            res = solver.ProjectedGradient(maxiter=60, tol=1e-6).run(
                fun, torch.zeros(3, 2, dtype=torch.float64), torch.full((2,), -1.0, dtype=torch.float64),
                torch.full((2,), 1.5, dtype=torch.float64))
    finally:
        solver.while_lanes = orig
    spans = _spans(tmp_path)
    iters = int(res.iters.max())
    assert len(set(res.iters.tolist())) > 1 and iters > 1
    assert len(_named(spans, "pg.iter")) == iters
    assert len(_named(spans, "lanes.sync")) == len(checks) > iters
