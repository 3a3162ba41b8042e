"""The reduction of a trace to per-layer metrics, on a canned trace."""

from __future__ import annotations

import gzip
import json

import pytest

from portbench.harness import peaks, spec, trace
from portbench.harness.measure import Context


def _canned():
    """Window 0-100 us. Two pb.spd spans (10-20, 50-60) launch a kernel each
    (K1 at 30-40, 70-75); an elementwise kernel at 35-50 overlaps the first;
    a copy launched in the entry span runs 90-95; a kernel after the window
    is ignored."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "ts": 0, "dur": 100, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "pb.entry", "ts": 1, "dur": 98, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "pb.spd", "ts": 10, "dur": 10, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "pb.spd", "ts": 50, "dur": 10, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 12, "dur": 2, "tid": 1,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 25, "dur": 2, "tid": 1,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 52, "dur": 2, "tid": 1,
         "args": {"correlation": 3}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 80, "dur": 2, "tid": 1,
         "args": {"correlation": 4}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 60, "dur": 20, "tid": 1},
        {"ph": "X", "cat": "kernel", "name": "spd_chol_warp_kernel<40>", "ts": 30, "dur": 10, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "elementwise", "ts": 35, "dur": 15, "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "spd_chol_warp_kernel<40>", "ts": 70, "dur": 5, "args": {"correlation": 3}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 90, "dur": 5, "args": {"correlation": 4}},
        {"ph": "X", "cat": "kernel", "name": "late", "ts": 150, "dur": 5, "args": {"correlation": 9}},
    ]
    return trace.Trace(ev)


class _Job:
    frames_per_call, fits_per_call = 100, 1

    class model:
        n_keypoints, nbody, jnt_type = 23, 20, [0] * 20
        arrays = {"nv": 37}


def _ctx(tr, counts=None, calls=1):
    return Context(tr, counts or {"spd": [(1000, 37), (2000, 37)], "pg": []}, _Job(), calls, 5 * 10**9)


def test_union_and_idle_share():
    tr = _canned()
    assert trace.union_s([(0, 10), (5, 15), (20, 30)], 0, 100) == 25
    assert trace.union_s([(0, 10), (5, 15)], 8, 12) == 4
    assert tr.busy_us() == 20 + 5 + 5  # 30-50 (two kernels overlap), 70-75, 90-95; the late kernel is outside
    assert spec.metric_reader("device.idle_pct.ik")(_ctx(tr)) == pytest.approx(100 * (1 - 30 / 100))
    assert trace.gaps([(10, 20), (15, 30)], 0, 50) == [(0, 10), (30, 50)]


def test_attribution_to_spans_and_the_spd_roofline():
    tr = _canned()
    k1 = tr.launched_in("pb.spd", ("kernel",))
    assert [d[0] for d in k1] == ["spd_chol_warp_kernel<40>"] * 2
    bound = peaks.spd_bound_s(1000, 37) + peaks.spd_bound_s(2000, 37)
    got = spec.metric_reader("spd.roofline_pct")(_ctx(tr))
    assert got == pytest.approx(100 * bound / 15e-6)
    assert spec.metric_reader("lm.kernels_per_iter")(_ctx(tr)) == 3 / 2
    assert spec.metric_reader("stac.wire_ms")(_ctx(tr)) == pytest.approx(5e-3)


def test_the_sharded_entries_rates():
    """Two ik_only_global spans (20 and 30 us) and one fit_offsets_sharded
    span (40 us) inside the window, one of each after it."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "ts": 0, "dur": 100, "tid": 1}]
    for name, ts, dur in (("pb.fit_sharded", 0, 40), ("pb.ik_global", 40, 20), ("pb.ik_global", 70, 30),
                          ("pb.fit_sharded", 120, 5), ("pb.ik_global", 130, 5)):
        ev.append({"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": 1})
    ctx = _ctx(trace.Trace(ev), calls=2)
    assert spec.metric_reader("dist.ik_fps")(ctx) == pytest.approx(2 * 100 / 50e-6)
    assert spec.metric_reader("dist.fit_s")(ctx) == pytest.approx(40e-6)


def test_spd_bound_is_the_smoke_scripts():
    import chip_smoke

    for F, n in ((10_000, 37), (250, 37), (40, 73)):
        assert peaks.spd_bound_s(F, n) * 1e3 == pytest.approx(chip_smoke._bound(F, n)[0], rel=1e-12)


def test_mfu_counts_operations_from_shapes():
    tr = _canned()
    per = peaks.lm_iteration_flops(69, 37, 19, 20, 23)
    # J'J's lower triangle (69 x 37 x 38 multiply-adds) and the Cholesky dominate
    assert per > 2 * 69 * 37 * 38 / 2 + 37**3 / 3
    got = spec.metric_reader("lm.mfu_pct")(_ctx(tr))
    assert got == pytest.approx(100 * 3000 * per / (100e-6 * peaks.FP32_FLOP_PER_S))


def test_idle_gaps_by_host_op_and_top_ops():
    tr = _canned()
    idle = dict(tr.idle_by_host())
    # gaps 0-30 (mid 15: pb.spd), 50-70 (mid 60: aten::mul starts at 60), 75-90 (mid 82.5: pb.entry), 95-100
    assert idle["pb.spd"] == pytest.approx(30e-6)
    assert idle["aten::mul"] == pytest.approx(20e-6)
    assert sum(idle.values()) == pytest.approx(70e-6)
    top = tr.top_ops()
    assert top[0] == ["spd_chol_warp_kernel<40>", pytest.approx(15e-6)]


def test_readers_find_nothing_and_say_so():
    empty = trace.Trace([{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "ts": 0, "dur": 10}])
    ctx = _ctx(empty, {"spd": [], "pg": []}, calls=0)
    for name in ("spd.roofline_pct", "lm.kernels_per_iter", "lm.mfu_pct", "stac.wire_ms", "mphase.device_ms",
                 "pg.ms_per_iter", "pg.kernels_per_iter", "device.idle_pct.ik", "dist.collective_ms",
                 "dist.ik_fps", "dist.fit_s"):
        assert spec.metric_reader(name)(ctx) is None, name


def test_written_trace_reads_back(tmp_path):
    path = tmp_path / "t.pt.trace.json.gz"
    with gzip.open(path, "wt") as fh:
        json.dump({"traceEvents": [{"ph": "X", "cat": "kernel", "name": "k", "ts": 1, "dur": 2}]}, fh)
    assert trace.Trace.load(path).device[0][:4] == ("k", "kernel", 1.0, 3.0)
