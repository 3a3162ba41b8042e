"""The tethered fruit fly on the port's throughput path, on the CPU.

``models/fly_tethered.xml`` is the flybody fruit fly as dm_control ships it,
without its free joint: a rootless body of 102 hinges, 68 bodies and 30 leg
keypoints, more unknowns (nv 102) than residual rows (m 90). Checked here:

- the checked-in bundle is the MJCF compiled by the port's builder (needs
  mujoco);
- the port's FK and analytic Jacobian against the benchmark's plain
  reference (``portbench/reference``) in float64 at seeded poses and
  offsets;
- a small ik of the benchmark's fly cell (``portbench/jobs/ik_fixed.py``)
  judged by the reference within the cell's limits, and its sessions the
  same for every seed;
- the float64 SPD reference against the port's plain solve at the fly's
  n, and a bfloat16 stand-in outside the kernel's tolerance;
- ``spd.device_ms`` on a canned trace.
"""

import sys

import numpy as np
import pytest
import torch

from _torch_common import REPO

if str(REPO) not in sys.path:  # portbench/ sits beside the package
    sys.path.insert(0, str(REPO))

from portbench.harness import check, spec, trace  # noqa: E402
from portbench.harness.gen import animal_offsets, make_recording, substream  # noqa: E402
from portbench.harness.measure import Context  # noqa: E402
from portbench.reference import spd as ref_spd  # noqa: E402
from portbench.reference.fk import FK  # noqa: E402
from portbench.reference.model import HINGE, Model  # noqa: E402
from stac_mjx_tpu_torch import bridge  # noqa: E402
from stac_mjx_tpu_torch.config import compose_config  # noqa: E402
from stac_mjx_tpu_torch.models import builder  # noqa: E402
from stac_mjx_tpu_torch.models.kinematics import make_fk, make_fk_jump  # noqa: E402
from stac_mjx_tpu_torch.ops import spd  # noqa: E402
from stac_mjx_tpu_torch.ops.gn_ik import GNIK  # noqa: E402

CELL = "fly-lm.ik-session"
BUNDLE = bridge.bundle_path("fly_tethered")
OVERRIDES = ["model=fly_tethered", "stac=stac_fly_tethered", "model.MJCF_PATH=models/fly_tethered.xml"]


def _fly_poses(frames=12, seed=3):
    """The reference model, and poses and offsets drawn about the
    generator's: in-range joint waves, moved by a seeded 0.05 rad, at
    animal 0's offsets moved by up to 0.01 model units."""
    model = Model(BUNDLE)
    fk = FK(model, "cpu")
    rec = make_recording(fk, 2, frames // 2, seed, offsets=animal_offsets(model, 0))
    gen = torch.Generator().manual_seed(seed)
    q = rec["qpos"] + 0.05 * torch.randn(rec["qpos"].shape, generator=gen, dtype=torch.float64)
    off = torch.as_tensor(rec["offsets"]) + 0.01 * (2 * torch.rand(rec["offsets"].shape, generator=gen,
                                                                      dtype=torch.float64) - 1)
    return model, fk, q, off


def test_fly_bundle_is_the_compiled_mjcf():
    """The checked-in bundle equals the port's builder on the MJCF (bitwise
    under the mujoco that wrote it, to 1e-12 under another), serves the
    fly's config, and is the body the benchmark's configuration states."""
    pytest.importorskip("mujoco")
    cfg = compose_config(REPO / "configs", overrides=OVERRIDES)
    got, want = builder.bundle_arrays(cfg, REPO), bridge.load_bundle(BUNDLE)
    assert sorted(got) == sorted(want)
    import mujoco

    for k, v in want.items():
        if mujoco.__version__ == bridge.BUNDLE_MUJOCO_VERSION or v.dtype.kind not in "f":
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-12, err_msg=k)
    assert bridge.bundle_for_config(cfg, REPO)["model_config"] == want["model_config"]
    assert (int(want["nq"]), int(want["nv"]), int(want["nbody"]), len(want["site_idxs"])) == (102, 102, 68, 30)
    assert set(want["jnt_type"].tolist()) == {HINGE} and int(want["root_kp_idx"]) == -1


@pytest.mark.parametrize("make", [make_fk, make_fk_jump], ids=["scan", "jump"])
def test_fly_fk_matches_the_reference_in_float64(make):
    model, fk, q, off = _fly_poses()
    fm = bridge.fit_model_from_arrays(model.arrays, "cpu", torch.float64)
    params = fm.params.set_site_pos(off, torch.as_tensor(model.site_idxs))
    theirs = make(fm.topo, "cpu")(params, q)
    ours = fk.frames(q)
    for key in ("xpos", "xquat", "xanchor", "xaxis"):
        assert float((getattr(theirs, key) - ours[key]).abs().max()) < 1e-12, key
    markers = theirs.site_xpos[:, torch.as_tensor(model.site_idxs)]
    assert float((markers - fk.markers(q, off)).abs().max()) < 1e-12


def test_fly_jacobian_matches_the_reference_in_float64():
    """Every dof of the fly is a hinge, so a step in dof space is a step in
    qpos: the port's analytic Jacobian equals the reference FK's central
    differences of the markers, (F, 90, 102). A step of 1e-6 rad leaves a
    truncation error near 1e-13 and a rounding error near 1e-11 model units
    (markers ~0.3 cm from their joints); the bound is 1e-9."""
    model, fk, q, off = _fly_poses(frames=4)
    fm = bridge.fit_model_from_arrays(model.arrays, "cpu", torch.float64)
    params = fm.params.set_site_pos(off, torch.as_tensor(model.site_idxs))
    gnik = GNIK(fm.topo, fm.site_idxs, "cpu")
    J = gnik.jacobian(gnik.fk(params, q))
    assert J.shape == (4, 90, 102)
    h = 1e-6
    step = h * torch.eye(102, dtype=torch.float64)
    qs = torch.cat([(q[:, None] + step).reshape(-1, 102), (q[:, None] - step).reshape(-1, 102)])
    plus, minus = fk.markers(qs, off).reshape(2, 4, 102, 90)
    want = ((plus - minus) / (2 * h)).transpose(1, 2)
    assert float((J - want).abs().max()) < 1e-9
    assert float(want.abs().max()) > 0.1


def _small_cell(clips=4, frames=32, pool=2):
    cell = spec.Cell(CELL)
    cell.traffic.update(clips=clips, clip_frames=frames, pool=pool)
    cell.config["stac"]["n_frames_per_clip"] = frames
    return cell


def test_fly_ik_is_within_the_cell_s_limits():
    """4 clips of 32 frames through ``Stac.ik_only`` with the cell's
    throughput settings (the fixed-root lockstep LM, hierarchical ik 8/6),
    judged by the reference in true mm against the cell's limits."""
    from portbench.jobs import ik_fixed

    cell = _small_cell(pool=1)
    job = ik_fixed.Job(cell, 12345, "cpu")
    assert job.stac._fixed and job.stac.stac_core_obj.gnik is not None
    record = job.call(0)
    assert record[1].shape == (4 * 32, 102)
    res = job.evaluate([record])
    ok, checks = check.judge(res["numbers"], cell.limits)
    assert ok, checks
    # True mm: the Tally's model-unit numbers times length_unit_m.
    tally = check.Tally(job.model)
    tally.add_poses(job.fk, record[1], job.offsets[0], job.kp[0], job.frames_per_call)
    assert res["numbers"]["worst_frame_mm"] == pytest.approx(0.01 * tally.numbers()["worst_frame_mm"])
    assert res["e2e"]["residual_mm"] == pytest.approx(0.01 * tally.residual_mm())
    assert 0 < res["e2e"]["residual_mm"] < 0.05


def test_ik_fixed_sessions_do_not_depend_on_the_seed():
    """Two seeds make the same sessions; the seed picks the first, and the
    calls alternate from it. The mean residual weighs each session alike,
    whatever the window's count of calls of each."""
    from portbench.jobs import ik_fixed

    cell = _small_cell(clips=2, frames=8)
    firsts = {s: substream(s, 6) % 2 for s in range(2**40, 2**40 + 40)}
    s0 = min(s for s, f in firsts.items() if f == 0)
    s1 = min(s for s, f in firsts.items() if f == 1)
    a, b = ik_fixed.Job(cell, s0, "cpu"), ik_fixed.Job(cell, s1, "cpu")
    assert (a.first, b.first) == (0, 1)
    assert len(a.kp) == len(b.kp) == 2 and not np.array_equal(a.kp[0], a.kp[1])
    for i in range(2):
        np.testing.assert_array_equal(a.kp[i], b.kp[i])
        np.testing.assert_array_equal(a.offsets[i], b.offsets[i])
    np.testing.assert_array_equal(a.offsets[0], animal_offsets(a.model, 0))
    calls = []
    a.stac.ik_only = lambda kp, off: calls.append(kp) or _Out(kp)
    b.stac.ik_only = a.stac.ik_only
    a.call(1), b.call(1)
    assert calls[0] is a.kp[1] and calls[1] is b.kp[0]
    # Three calls, session 0 twice: the mean is of the two sessions' means.
    recs = [a.call(0), a.call(1), a.call(2)]
    res = a.evaluate([(r, _truth(a, r), m) for r, _, m in recs])
    tallies = []
    for r in (0, 1):
        t = check.Tally(a.model)
        t.add_poses(a.fk, _truth(a, r), a.offsets[r], a.kp[r], a.frames_per_call)
        tallies.append(t.residual_mm())
    assert res["e2e"]["residual_mm"] == pytest.approx(0.01 * np.mean(tallies))


class _Out:
    def __init__(self, kp):
        self.qpos, self.marker_sites = np.zeros((len(kp), 102), np.float32), None


def _truth(job, r):
    """Session r's generating poses, with one frame moved so that its
    residual is not at float32's floor."""
    tr = job.traffic
    rec = make_recording(job.fk, int(tr["clips"]), int(tr["clip_frames"]), substream(0, 5, r),
                         offsets=animal_offsets(job.model, 0))
    q = rec["qpos"].numpy().copy()
    q[r, 3] += 0.1 * (r + 1)
    return q


@pytest.mark.parametrize("how", ["unchanged", "half", "control"])
def test_fly_cell_catches_a_broken_run(how):
    """The cell's check at a small size on the CPU: poses handed back
    unsolved (all, or half of each batch: the first quartile stays on the
    solved half, the worst frame does not), or solved on the bfloat16
    reference FK (the control), come out not correct."""
    from portbench import run
    from portbench.harness.faults import planted

    cell = _small_cell(clips=2, frames=16, pool=1)
    if how == "control":
        result, checks = run.run_cell(cell, 4_000_000_123, 0.1, 0, control=True, device="cpu")
    else:
        with planted(how):
            result, checks = run.run_cell(cell, 4_000_000_123, 0.1, 0, device="cpu")
    assert not result["correct"], checks
    over = "worst_frame_mm" if how == "half" else "resid_p25_mm"
    assert checks[over]["value"] > checks[over]["limit"], checks


@pytest.mark.parametrize("n", [97, 102, 128])
def test_spd_reference_is_the_plain_solve_and_bf16_fails_the_tolerance(n):
    """The benchmark's float64 SPD solve equals the port's plain version in
    float64 on the LM's systems at the fly's sizes; A rounded to bfloat16
    misses the kernel's tolerance (1e-4 of max |x|, PERF.md) by far, and
    float32 (the kernel's precision) meets it."""
    gen = torch.Generator().manual_seed(n)
    J = torch.randn(64, 2 * n, n, generator=gen, dtype=torch.float64)
    A = J.mT @ J + 1e-4 * torch.eye(n, dtype=torch.float64)
    g = torch.randn(64, n, generator=gen, dtype=torch.float64)
    lam = torch.rand(64, generator=gen, dtype=torch.float64)
    x = ref_spd.spd_solve(A, g, lam, block=20)
    assert ref_spd.relative_error(spd.spd_solve_plain(A, g, lam), x) < 1e-12
    f32 = spd.spd_solve_plain(A.float(), g.float(), lam.float())
    assert ref_spd.relative_error(f32, x) < 1e-4
    bf16 = ref_spd.spd_solve(A.bfloat16().double(), g, lam)
    assert ref_spd.relative_error(bf16, x) > 1e-3
    bad = torch.diag(torch.tensor([1.0, -1.0], dtype=torch.float64))[None]
    assert not torch.isfinite(ref_spd.spd_solve(bad, torch.ones(1, 2, dtype=torch.float64))).any()


class _Job:
    frames_per_call, fits_per_call = 180_000, 0

    class model:
        n_keypoints, nbody, jnt_type = 30, 68, [3] * 102
        arrays = {"nv": 102}


def _span(name, ts, end):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": end - ts, "tid": 1}


def _kernel(name, ts, end, corr, launched):
    return [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": launched, "dur": 0.5, "tid": 1,
             "args": {"correlation": corr}},
            {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": end - ts, "args": {"correlation": corr}}]


@pytest.mark.parametrize("calls", [1, 3])
def test_spd_device_ms_reads_the_kernels_launched_in_spd_spans(calls):
    """Two K1 launches inside ``spd`` spans (10 and 30 us) and a kernel
    launched outside them: 40 us over the traced calls; a trace without the
    span (the parent's program) reads nothing."""
    ev = [_span(trace.WINDOW, 0, 200), _span("pb.spd", 4, 30), _span("spd", 5, 8),
          _span("pb.spd", 90, 120), _span("spd", 95, 99), _span("spd", 300, 310)]
    ev += _kernel("spd_chol_wide_kernel<8>", 20, 30, 1, 6) + _kernel("spd_chol_wide_kernel<8>", 100, 130, 2, 96)
    ev += _kernel("gemm", 40, 60, 3, 35) + _kernel("spd_chol_wide_kernel<8>", 305, 306, 4, 301)
    read = spec.metric_reader("spd.device_ms")
    ctx = Context(trace.Trace(ev), {"spd": [(22_800, 102), (180_000, 102)], "pg": []}, _Job(), calls, 0)
    assert read(ctx) == pytest.approx(40e-3 / calls)
    parent = trace.Trace([e for e in ev if e.get("name") != "spd"])
    assert read(Context(parent, {"spd": [], "pg": []}, _Job(), calls, 0)) is None


def test_dispatch_width_rounds_n_up_to_eight():
    assert [spd.dispatch_width(n) for n in (1, 8, 9, 37, 73, 96, 97, 102, 113, 128)] == [
        8, 8, 16, 40, 80, 96, 104, 104, 120, 128]
