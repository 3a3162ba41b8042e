"""Multi-process runs of the port (``stac_mjx_tpu_torch.parallel``) against the
JAX package's sharded programs, on the CPU.

Two ranks run as subprocesses over gloo (``tests/_torch_dist_worker.py``,
each with a timeout; no process group is ever made in the pytest process)
while this process computes the JAX side on ``clip_mesh(2)``: the
all-reduced closed-form m-phase against ``shard_map`` + ``psum``,
``psum_error_stats``, the frame-sharded fit (16 frames, N_ITERS 2, a
sample of 5 of each shard's 8 frames, so the shard-folded PRNG key picks
them) and ``ik_only_global`` in float64. ``run_stac_distributed`` runs with
one process (equal to the port's ``run_stac``) and under torchrun with two
(h5 files that ``io.load_stac_data`` reads).
"""

import json
import logging
import os
import shutil
import socket
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import x64_mode
from _torch_common import REPO, THROUGHPUT, bridge, jax_stac
from stac_mjx_tpu import pipeline as jpipe
from stac_mjx_tpu.models import firstparty as jfirstparty
from stac_mjx_tpu.models.builder import extract_model
from stac_mjx_tpu.ops.solver import m_opt_closed_form as jax_m_opt
from stac_mjx_tpu.parallel import distributed as jdist
from stac_mjx_tpu.parallel.mesh import CLIP_AXIS, clip_mesh
from stac_mjx_tpu_torch import cli, io, main
from stac_mjx_tpu_torch.config import compose_config
from stac_mjx_tpu_torch.parallel import distributed as tdist
from stac_mjx_tpu_torch.parallel.mesh import ClipGroup, shard_clips
from stac_mjx_tpu_torch.utils import prng

try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

FIT = dict(THROUGHPUT, n_frames_per_clip=4)
MODEL = {"N_ITERS": 2, "N_SAMPLE_FRAMES": 10}
N_FRAMES, N_CLIPS = 16, 4
WORKER_TIMEOUT_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env() -> dict:
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env["PYTHONPATH"] = str(REPO)
    return env


def _wait(procs, what):
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=WORKER_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            pytest.fail(f"{what} timed out after {WORKER_TIMEOUT_S} s")
        logs.append(out)
    for i, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"{what} {i} failed:\n{log[-3000:]}"


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The workers' outputs and, computed meanwhile, the JAX side's inputs."""
    tmp = tmp_path_factory.mktemp("ranks")
    rng = np.random.default_rng(7)
    T, K = 12, 23
    R = np.linalg.qr(rng.normal(size=(T, K, 3, 3)))[0]
    js = jax_stac(FIT, MODEL)
    kp, _, _, _ = jfirstparty.make_recording(js.cfg, n_frames=N_FRAMES, seed=3, base_path=".")
    b = bridge.load_bundle()
    inputs = dict(
        p_all=rng.normal(size=(T, K, 3)), R_all=R, y=rng.normal(size=(T, K, 3)), m0=rng.normal(size=(K, 3)),
        isr=(rng.uniform(size=(K, 3)) > 0.5).astype(np.float64), reg=np.float64(0.7),
        errors=rng.normal(2.0, 0.5, (8, 10)),
        kp=np.asarray(kp, np.float32).astype(np.float64), n_clips=N_CLIPS,
        ik_offsets=np.asarray(b["site_pos"])[b["site_idxs"]].astype(np.float64),
        stac_cfg=json.dumps(FIT), model=json.dumps(MODEL),
    )
    np.savez(tmp / "inputs.npz", **inputs)
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "_torch_dist_worker.py"), str(port), "2", str(r),
             str(tmp / "inputs.npz"), str(tmp)],
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(2)
    ]
    try:
        jax_side = _jax_side(js, b, inputs)
    finally:
        _wait(procs, "rank")
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]
    return SimpleNamespace(ranks=ranks, jax=jax_side, inputs=inputs)


def _jax_side(js, b, x) -> dict:
    mesh = clip_mesh(2)
    shard = NamedSharding(mesh, P(CLIP_AXIS))
    core, cfg = js.stac_core_obj, js._static_cfg
    out = {}
    with x64_mode():
        m = jax.jit(shard_map(
            lambda p, R, y: tuple(jax_m_opt(p, R, y, jnp.asarray(x["m0"]), jnp.asarray(x["isr"]), x["reg"],
                                            axis_name=CLIP_AXIS)),
            mesh=mesh, in_specs=(P(CLIP_AXIS),) * 3, out_specs=(P(), P()), check_vma=False,
        ))(*(jax.device_put(jnp.asarray(x[k]), shard) for k in ("p_all", "R_all", "y")))
        out["m_params"], out["m_error"] = (np.asarray(a) for a in m)
        stats = jax.jit(shard_map(jdist.psum_error_stats, mesh=mesh, in_specs=(P(CLIP_AXIS),),
                                  out_specs=(P(), P()), check_vma=False))(jnp.asarray(x["errors"]))
        out["stats"] = np.array([float(s) for s in stats])

        _, p64 = extract_model(js._mj_model, dtype=jnp.float64)
        lb, ub, isr = (jnp.asarray(b[k]) for k in ("lb", "ub", "is_regularized"))
        run = jpipe.fit_offsets_sharded(core, cfg, mesh, CLIP_AXIS)
        out["fit"] = jax.device_get(jax.jit(run)(p64, jax.device_put(jnp.asarray(x["kp"]), shard), lb, ub, isr))
        clips = jax.device_put(jnp.asarray(x["kp"].reshape(N_CLIPS, -1, x["kp"].shape[-1])), shard)
        out["ik"] = jax.device_get(jax.jit(
            lambda p, k, o: jpipe.ik_only_program(core, cfg, p, k, o, lb, ub, return_full=True)
        )(p64, clips, jnp.asarray(x["ik_offsets"])))
    return out


def test_fold_in_and_keyed_permutation_match_jax():
    """Bit for bit: the shard-folded keys and the permutations under them."""
    for shard in range(8):
        key = jax.random.fold_in(jax.random.PRNGKey(0), shard)
        want = tuple(int(v) for v in np.asarray(jax.random.key_data(key)))
        got = prng.fold_in(prng.key_from_seed(0), shard)
        assert got == want, shard
        for n in (1, 5, 8, 125, 1000):
            perm = np.asarray(jax.random.permutation(key, jnp.arange(n), independent=True))
            np.testing.assert_array_equal(prng.permutation(n, key=got), perm)
    np.testing.assert_array_equal(prng.permutation(50), prng.permutation(50, key=prng.key_from_seed(0)))


def test_m_opt_all_reduced_matches_jax_psum(two_ranks):
    """Two ranks' all-reduced closed form against shard_map + psum on two
    devices: the same float64 sums in another order, 1e-12."""
    for r in two_ranks.ranks:
        np.testing.assert_allclose(r["m_params"], two_ranks.jax["m_params"], rtol=0, atol=1e-12)
        np.testing.assert_allclose(r["m_error"], two_ranks.jax["m_error"], rtol=1e-12)


def test_psum_error_stats_matches_jax(two_ranks):
    """Mean and std of errors split over two ranks, against the JAX psum: 1e-12."""
    for r in two_ranks.ranks:
        np.testing.assert_allclose(r["stats"], two_ranks.jax["stats"], rtol=1e-12)
    errs = two_ranks.inputs["errors"]
    np.testing.assert_allclose(two_ranks.ranks[0]["stats"], [errs.mean(), errs.std()], rtol=1e-12)


def test_sharded_fit_matches_jax(two_ranks):
    """The two-rank fit against ``pipeline.fit_offsets_sharded`` on
    clip_mesh(2), float64: offsets and markers 1e-8 m; qpos 1e-5 rad, the
    bound of test_torch_pipeline.py's fit (a near-null direction of JtJ, the
    tail twist, amplifies float64 rounding there; ROADMAP §3). Every rank
    returns the whole fit, bitwise the same."""
    r0, r1 = two_ranks.ranks
    want = two_ranks.jax["fit"]
    for k in ("fit_qpos", "fit_offsets", "fit_marker_sites", "fit_xpos"):
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    assert r0["fit_qpos"].shape == (N_FRAMES, 44)
    np.testing.assert_array_equal(r0["fit_kp_data"], two_ranks.inputs["kp"])
    np.testing.assert_allclose(r0["fit_offsets"], want["offsets"], rtol=0, atol=1e-8)
    np.testing.assert_allclose(r0["fit_marker_sites"], want["marker_sites"], rtol=0, atol=1e-8)
    np.testing.assert_allclose(r0["fit_qpos"], want["qpos"], rtol=0, atol=1e-5)


def test_ik_only_global_matches_jax(two_ranks):
    """Two ranks of two clips each against the JAX ik over the four clips
    sharded on clip_mesh(2), float64: qpos 1e-6 (test_torch_pipeline.py's
    ik bound); both ranks return the same whole result, bitwise."""
    r0, r1 = two_ranks.ranks
    assert list(r0["clip_range"]) == [0, 2] and list(r1["clip_range"]) == [2, 4]
    for k in ("ik_qpos", "ik_xpos", "ik_xquat", "ik_marker_sites", "ik_kp_data", "ik_offsets"):
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    qpos, _, _, markers, _ = two_ranks.jax["ik"]
    np.testing.assert_allclose(r0["ik_qpos"], np.asarray(qpos).reshape(N_FRAMES, -1), rtol=0, atol=1e-6)
    np.testing.assert_allclose(r0["ik_marker_sites"], np.asarray(markers).reshape(N_FRAMES, 23, 3), rtol=0, atol=1e-8)
    np.testing.assert_array_equal(r0["gathered_rows"], np.repeat([[0.0], [1.0]], [2, 2], axis=0) * np.ones(3))


def test_local_clip_range_matches_jax():
    """The clip block of a rank, and both ValueErrors, against the JAX
    function on meshes laid out as the same process order (its devices
    duck-typed by process_index; this process is process 0)."""
    for order in ((0,), (0, 1), (0, 0, 1, 1), (1, 1, 0, 0), (1, 1), (0, 1, 0, 1)):
        jmesh = SimpleNamespace(devices=np.array([SimpleNamespace(process_index=p) for p in order]))
        group = ClipGroup(None, order, 0, torch.device("cpu"))
        for n in (8, 16, 9):
            try:
                want = jdist.local_clip_range(n, jmesh)
            except ValueError as e:
                with pytest.raises(ValueError) as got:
                    tdist.local_clip_range(n, group)
                if "divide" in str(e):
                    assert str(got.value) == str(e)
                else:
                    assert "not contiguous" in str(got.value) and "not contiguous" in str(e)
                continue
            assert tdist.local_clip_range(n, group) == want, (order, n)


def test_shard_clips_and_frame_count(caplog):
    data = np.arange(8 * 3).reshape(8, 3)
    assert shard_clips(data, ClipGroup(None, (0,), 0, torch.device("cpu"))) is data
    np.testing.assert_array_equal(shard_clips(data, ClipGroup(None, (0, 1), 1, torch.device("cpu"))), data[4:])
    with caplog.at_level(logging.WARNING):
        assert shard_clips(data[:7], ClipGroup(None, (0, 1), 1, torch.device("cpu"))).shape[0] == 7
    assert "do not divide" in caplog.text
    for n, dev in ((250, 2), (251, 2), (7, 4)):
        assert tdist._local_frame_count(n, dev, "fit frames") == jdist._local_frame_count(n, dev, "fit frames")
    with pytest.raises(ValueError, match="need at least one per device"):
        tdist._local_frame_count(1, 2, "fit frames")


# ----------------------------------------------------------- the driver

N_REC, N_FIT, CLIP = 40, 20, 10
OVERRIDES = [
    "model=firstparty", "stac=firstparty", "stac.data_path=rec.nwb", "stac.pose_mode=lockstep",
    "stac.q_solver=gn-lm", "stac.skip_part_opt=true", "stac.fk_impl=jump", f"stac.n_fit_frames={N_FIT}",
    f"stac.n_frames_per_clip={CLIP}", "stac.continuous=true", "stac.infer_qvels=true", "model.N_ITERS=2",
]


@pytest.fixture(scope="module")
def recording(tmp_path_factory):
    from stac_mjx_tpu.config import compose_config as jcompose

    root = tmp_path_factory.mktemp("rec")
    jcfg = jcompose(REPO / "configs", overrides=OVERRIDES)
    jfirstparty.write_recording_nwb(root / "rec.nwb", jcfg, n_frames=N_REC, seed=4, base_path=REPO)
    return root / "rec.nwb"


def _argv(base):
    return ["--config-path", str(REPO / "configs"), "--base-path", str(base)] + OVERRIDES


def _artifacts(base) -> dict:
    cfg = compose_config(REPO / "configs", overrides=OVERRIDES)
    return {what: io.load_stac_data(base / getattr(cfg.stac, f"{what}_path")) for what in ("fit_offsets", "ik_only")}


def test_run_stac_distributed_one_process_is_run_stac(recording, tmp_path):
    """``--distributed`` in a single process (no torchrun environment):
    init_distributed does nothing and run_stac_distributed's artifacts equal
    the port's run_stac's, bitwise."""
    for d in ("dist", "plain"):
        (tmp_path / d).mkdir()
        shutil.copy(recording, tmp_path / d / "rec.nwb")
    assert cli.main(_argv(tmp_path / "dist") + ["--distributed", "--cpu"]) == 0
    cfg = compose_config(REPO / "configs", overrides=OVERRIDES)
    kp, names = io.load_data(cfg, base_path=tmp_path / "plain")
    main.run_stac(cfg, kp, names, base_path=tmp_path / "plain", device="cpu")
    got, want = _artifacts(tmp_path / "dist"), _artifacts(tmp_path / "plain")
    for what in got:
        assert got[what][0].to_dict() == want[what][0].to_dict()
        for k, v in want[what][1].as_dict().items():
            np.testing.assert_array_equal(getattr(got[what][1], k), v, err_msg=f"{what}.{k}")


def test_run_stac_distributed_two_processes_under_torchrun(recording, tmp_path):
    """torchrun --nproc-per-node 2 -m stac_mjx_tpu_torch.cli --distributed
    --cpu: rank 0 writes both h5 files, which io.load_stac_data reads; the
    fit (10 frames per rank) and the ik (2 clips per rank, continuous, with
    qvel) have the one-process run's shapes and residuals under 5 mm."""
    shutil.copy(recording, tmp_path / "rec.nwb")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2", "--master-addr", "localhost",
           "--master-port", str(_free_port()), "-m", "stac_mjx_tpu_torch.cli", "--distributed", "--cpu"]
    proc = subprocess.Popen(cmd + _argv(tmp_path), env=dict(_env(), OMP_NUM_THREADS="1"), cwd=tmp_path,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _wait([proc], "torchrun")
    art = _artifacts(tmp_path)
    fit, ik = art["fit_offsets"][1], art["ik_only"][1]
    assert fit.qpos.shape == (N_FIT, 44) and ik.qpos.shape == (N_REC, 44) and ik.qvel.shape == (N_REC, 43)
    for d in (fit, ik):
        n = d.qpos.shape[0]
        resid = np.linalg.norm(d.marker_sites.reshape(n, -1, 3) - d.kp_data.reshape(n, -1, 3), axis=-1).mean()
        assert np.isfinite(d.qpos).all() and resid < 5e-3, resid
    np.testing.assert_array_equal(ik.offsets, fit.offsets)
