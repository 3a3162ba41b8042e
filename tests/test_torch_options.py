"""The JAX Stac's last options in the port, on the CPU: stall freezing in the
batched flat LM against the JAX ``solve_batch`` (float64), the float16 wire
(uplink arrays bitwise against the JAX Stac's; results against the float32
wire within the JAX tests' bounds), the artifact's keypoints on either wire,
chunked ik against one batch (bitwise) and the chunk policy against the JAX
rule, and ``seq_segment_frames`` accepted without effect."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import x64_mode
from _torch_common import THROUGHPUT, TorchStac, bridge, jax_stac, torch_stac
from stac_mjx_tpu.models import firstparty as jfirstparty
from stac_mjx_tpu.models.builder import extract_model
from stac_mjx_tpu.ops.gn_ik import GNIK as JaxGNIK
from stac_mjx_tpu_torch.ops.gn_ik import GNIK
from stac_mjx_tpu_torch.stac import wire_encode

# The JAX tests' critter (tests/test_pipeline.py::_critter): lockstep gn-lm
# with the part passes, clips of 8, a 16-frame recording from seed 11.
CRITTER = dict(THROUGHPUT, skip_part_opt=False, n_frames_per_clip=8)
SEQ = {"pose_mode": "sequential", "q_solver": "pg", "skip_part_opt": True, "n_frames_per_clip": 8}
SEQ_MODEL = {"N_ITER_Q": 15, "N_ITERS": 2, "N_SAMPLE_FRAMES": 6}


@pytest.fixture(scope="module")
def critter_kp():
    js = jax_stac(CRITTER)
    kp, _, _, _ = jfirstparty.make_recording(js.cfg, n_frames=16, seed=11, base_path=".")
    return np.asarray(kp, np.float32)


def _resid(d, markers) -> float:
    n = d.qpos.shape[0]
    return float(np.linalg.norm(markers.reshape(n, -1, 3) - d.kp_data.reshape(n, -1, 3), axis=-1).mean())


# ----------------------------------------------------------------- stall


@pytest.mark.parametrize("stall", [2, 0])
def test_stall_freezing_matches_jax_f64(stall):
    """solve_batch with gn_stall_iters over 40 frames (40 iterations at most)
    against the JAX one, float64: the same lanes freeze at the same
    iterations, so q agrees to 1e-8 and the loop's iteration count is
    equal; with stall 2 it ends early (33 iterations), with 0 it runs all 40."""
    js = jax_stac({})
    b = bridge.load_bundle()
    rng = np.random.default_rng(2)
    F = 40
    q_true = np.tile(b["qpos0"], (F, 1)) + rng.normal(0, 0.3, (F, 44))
    q0 = q_true + rng.normal(0, 0.1, (F, 44))
    qs, kps = np.ones(44, bool), np.ones(69)
    jg = JaxGNIK(js.topo, js._body_site_idxs, maxiter=40, tol=1e-8, fk_impl="jump", linesearch=False,
                 spd_impl="xla", stall_iters=stall)
    with x64_mode():
        _, p64 = extract_model(js._mj_model, dtype=jnp.float64)
        kp = np.array(jax.vmap(lambda q: jg.fk(p64, q).site_xpos[js._body_site_idxs].reshape(-1))(jnp.asarray(q_true)))
        lb, ub = jnp.asarray(b["lb"]), jnp.asarray(b["ub"])
        jr = jax.device_get(jax.jit(
            lambda k, q: jg.solve_batch(p64, k, jnp.asarray(qs), jnp.asarray(kps), q, lb, ub)
        )(jnp.asarray(kp), jnp.asarray(q0)))
    fm = bridge.fit_model_from_arrays(b, "cpu", torch.float64)
    tg = GNIK(fm.topo, fm.site_idxs, "cpu", maxiter=40, tol=1e-8, stall_iters=stall)
    tr = tg.solve_batch(fm.params, torch.as_tensor(kp), torch.as_tensor(qs), torch.as_tensor(kps),
                        torch.as_tensor(q0), torch.as_tensor(b["lb"]), torch.as_tensor(b["ub"]))
    np.testing.assert_array_equal(tr.iters.numpy(), jr.iters)
    assert (int(tr.iters[0]) < 40) == (stall > 0)
    np.testing.assert_allclose(tr.params.numpy(), jr.params, rtol=0, atol=1e-8)
    np.testing.assert_allclose(tr.value.numpy(), jr.value, rtol=1e-8, atol=1e-20)


def test_stall_option_reaches_the_solver(critter_kp):
    """gn_stall_iters=3 through Stac: the fit ends no worse than without it
    (frozen lanes had stopped gaining)."""
    kp = critter_kp
    base = torch_stac(dict(CRITTER, skip_part_opt=True), {"N_ITERS": 1})
    stall = torch_stac(dict(CRITTER, skip_part_opt=True, gn_stall_iters=3), {"N_ITERS": 1})
    assert stall.stac_core_obj.gnik.stall_iters == 3
    f0, f1 = base.fit_offsets(kp), stall.fit_offsets(kp)
    assert _resid(f1, f1.marker_sites) <= 1.02 * _resid(f0, f0.marker_sites)


# ------------------------------------------------------------ float16 wire


def _capture(js, attr):
    """Patch the JAX Stac's program getter ``attr`` to record the arrays it is
    called with and stop there."""
    seen = {}

    class Stop(Exception):
        pass

    def getter(*_args):
        def fn(params, kp_w, center, *rest):
            seen.update(kp_w=np.asarray(kp_w), center=np.asarray(center))
            raise Stop

        return fn

    return seen, Stop, mock.patch.object(js, attr, getter)


def test_wire_uplink_matches_jax_bitwise(critter_kp):
    """The float16 keypoints and float32 centre the JAX Stac sends, for the
    fit (F, 3K) and for the ik (its clip batch, continuous windows
    included), equal the port's bitwise."""
    from stac_mjx_tpu_torch.utils.batching import batch_kp_data

    near = np.tile(critter_kp, (3, 1))  # 48 frames: 4 continuous windows of 12 + 10
    far = (near.reshape(48, -1, 3) + np.float32([64.0, -64.0, 32.0])).reshape(48, -1)
    for kp in (near, far):
        for cont in (False, True):
            js = jax_stac(dict(CRITTER, wire_dtype="float16", continuous=cont, n_frames_per_clip=12))
            seen, stop, patch = _capture(js, "_get_fit_fn")
            with patch, pytest.raises(stop):
                js.fit_offsets(kp)
            send, center = wire_encode(kp)
            np.testing.assert_array_equal(send, seen["kp_w"])
            np.testing.assert_array_equal(center, seen["center"])
            assert send.dtype == np.float16 and center.dtype == np.float32
            seen, stop, patch = _capture(js, "_get_ik_fn_wire")
            with patch, pytest.raises(stop):
                js.ik_only(kp, js._offsets)
            send, center = wire_encode(batch_kp_data(kp, 12, continuous=cont))
            np.testing.assert_array_equal(send, seen["kp_w"])
            np.testing.assert_array_equal(center, seen["center"])


@pytest.fixture(scope="module")
def wire_pair():
    return torch_stac(CRITTER), torch_stac(dict(CRITTER, wire_dtype="float16"))


def test_wire_f16_ik_matches_f32(critter_kp, wire_pair):
    """tests/test_pipeline.py::test_wire_f16_matches_f32's bounds: qpos
    2e-2, the residual of markers recomputed from the wire's qpos within
    2e-4 m of the float32 run's, the artifact's keypoints the float32 ones."""
    s32, s16 = wire_pair
    offs = s32._offsets
    full, wire = s32.ik_only(critter_kp, offs), s16.ik_only(critter_kp, offs)
    np.testing.assert_allclose(wire.qpos, full.qpos, atol=2e-2)
    _, _, ms16 = s16.compute_full_outputs(wire.qpos)
    assert abs(_resid(wire, ms16) - _resid(full, full.marker_sites)) < 2e-4
    np.testing.assert_array_equal(wire.kp_data, full.kp_data)
    assert wire.qpos.dtype == np.float32


def test_wire_f16_off_origin_recording(critter_kp, wire_pair):
    """test_pipeline.py::test_wire_f16_off_origin_recording's bounds on a
    recording shifted by (64, -64, 32) m: root translation and markers 2e-3,
    xpos 2e-2 (an uncentred float16 downlink would quantise at ~3e-2 there),
    the worldbody row exactly 0."""
    s32, s16 = wire_pair
    far = (critter_kp.reshape(16, -1, 3) + np.float32([64.0, -64.0, 32.0])).reshape(16, -1)
    full, wire = s32.ik_only(far, s32._offsets), s16.ik_only(far, s32._offsets)
    np.testing.assert_allclose(wire.qpos[:, :3], full.qpos[:, :3], atol=2e-3)
    np.testing.assert_allclose(wire.marker_sites, full.marker_sites, atol=2e-3)
    np.testing.assert_allclose(wire.xpos, full.xpos, atol=2e-2)
    np.testing.assert_array_equal(wire.xpos[:, 0], 0.0)


def test_wire_f16_fit_matches_f32(critter_kp, wire_pair):
    """test_pipeline.py::test_fit_wire_f16_matches_f32's bounds: offsets
    5e-4, markers 2e-3, qpos 2e-2; the artifact keeps the float32 keypoints."""
    s32, s16 = wire_pair
    full, wire = s32.fit_offsets(critter_kp), s16.fit_offsets(critter_kp)
    np.testing.assert_allclose(wire.offsets, full.offsets, atol=5e-4)
    np.testing.assert_allclose(wire.marker_sites, full.marker_sites, atol=2e-3)
    np.testing.assert_allclose(wire.qpos, full.qpos, atol=2e-2)
    np.testing.assert_array_equal(wire.kp_data, full.kp_data)


# --------------------------------------------------- segments and chunks


def _seq_run(kp, stac: dict):
    """A sequential pg fit and ik on kp, and the per-frame errors each
    reported (the fit's per pass, then its final pass's; the ik's)."""
    st, errors = torch_stac(stac, SEQ_MODEL), []
    report = TorchStac._error_stats
    with mock.patch.object(TorchStac, "_error_stats", staticmethod(lambda e: errors.append(e) or report(e))):
        fit = st.fit_offsets(kp)
        ik = st.ik_only(kp, st._offsets)
    return fit, ik, errors


@pytest.fixture(scope="module")
def seq_one_call(critter_kp):
    """The sequential run on the recording's first 8 frames without the
    segment key: the one call."""
    return _seq_run(critter_kp[:8], SEQ)


@pytest.mark.parametrize("seg", [-1, 0, 3, 10])
def test_seq_segment_frames_gives_the_one_call(critter_kp, seq_one_call, seg):
    """stac.seq_segment_frames is accepted without effect (the JAX
    package's segments bound a TPU program's size; the port's sequential
    pass is a host loop over frames): the fit's and the ik's poses,
    offsets, markers and per-frame errors are the one call's, bitwise."""
    fit, ik, errors = _seq_run(critter_kp[:8], dict(SEQ, seq_segment_frames=seg))
    for got, want in zip((fit, ik), seq_one_call):
        for k in ("qpos", "xpos", "xquat", "marker_sites", "offsets"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
    assert len(errors) == len(seq_one_call[2]) == SEQ_MODEL["N_ITERS"] + 2
    for got, want in zip(errors, seq_one_call[2]):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("wire", ["float32", "float16"])
@pytest.mark.parametrize("entry", ["fit_offsets", "ik_only"])
def test_artifact_keypoints_are_the_callers(critter_kp, entry, wire):
    """The artifact's kp_data is the caller's array, bitwise, packaged from
    the host array that was uploaded: in the compute dtype on the float32
    wire (float64 here), float32 on the float16 wire, and a copy of its own."""
    st = torch_stac(dict(CRITTER, skip_part_opt=True, wire_dtype=wire), {"N_ITERS": 1}, dtype=torch.float64)
    kp = critter_kp.copy()
    data = st.fit_offsets(kp) if entry == "fit_offsets" else st.ik_only(kp, st._offsets)
    want = np.float64 if wire == "float32" else np.float32
    assert data.kp_data.dtype == want
    np.testing.assert_array_equal(data.kp_data, critter_kp.astype(want))
    kp[:] = 0.0  # the artifact holds its own copy
    np.testing.assert_array_equal(data.kp_data, critter_kp.astype(want))


def test_chunked_ik_equals_one_batch():
    """16 clips of 5 frames in chunks of 4 against one batch: bitwise
    (test_pipeline.py::test_ik_chunked_pipeline_matches_single_program),
    full and lean payload."""
    cfg = dict(THROUGHPUT, n_frames_per_clip=5)
    js = jax_stac(cfg)
    kp, _, _, _ = jfirstparty.make_recording(js.cfg, n_frames=80, seed=3, base_path=".")
    one, chunked = torch_stac(dict(cfg, ik_chunk_clips=-1)), torch_stac(dict(cfg, ik_chunk_clips=4))
    assert (one._ik_chunk(16), chunked._ik_chunk(16)) == (0, 4)
    a, b = one.ik_only(kp, one._offsets), chunked.ik_only(kp, one._offsets)
    for k in ("qpos", "xpos", "xquat", "marker_sites"):
        np.testing.assert_array_equal(getattr(b, k), getattr(a, k), err_msg=k)
    np.testing.assert_array_equal(chunked.ik_only(kp, one._offsets, return_full=False).qpos, a.qpos)


@pytest.mark.parametrize("chunk", [-1, 1, 4, 5, 8, 16, 32])
def test_chunk_policy_matches_jax(chunk):
    """Explicit values follow the JAX rule on one device (n > 0 chunks where
    it divides the clip count and is below it; -1 off). Auto (0) is off in
    the port, where the JAX rule picks the divisor nearest 8 from 16 clips."""
    cfg = dict(THROUGHPUT, n_frames_per_clip=5, ik_chunk_clips=chunk)
    js, st = jax_stac(cfg), torch_stac(cfg)
    with mock.patch.object(jax, "devices", lambda *a: jax.local_devices()[:1]):
        for n in (10, 16, 40):
            assert st._ik_chunk(n) == js._ik_chunk(n), (chunk, n)
        assert js._ik_chunk(1) == st._ik_chunk(1) == 0
    if chunk == -1:
        auto = torch_stac(dict(cfg, ik_chunk_clips=0))
        assert [auto._ik_chunk(n) for n in (10, 16, 40)] == [0, 0, 0]
        with mock.patch.object(jax, "devices", lambda *a: jax.local_devices()[:1]):
            assert jax_stac(dict(cfg, ik_chunk_clips=0))._ik_chunk(40) == 8
