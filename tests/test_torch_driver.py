"""The pipeline driver (``main.run_stac``, ``cli.main``) of both packages on
a firstparty NWB recording: lockstep gn-lm, a 20-frame fit, 40 frames of
continuous ik in clips of 10 with qvel inference, float32 on both sides (the
JAX ``Stac`` builds its model in float32).

The solves are held by quality, as in ``test_torch_pipeline_f32.py``: fit
and ik residuals within 2% of JAX's, offset error no worse than JAX's + 10%.
The driver's own steps are held exactly: the crossfade bitwise, qvel within
the float32 bounds of ``test_torch_velocity.py``. The artifacts have one
schema, and a fit h5 of either package resumes the other's ik.
"""

import contextlib
import copy
import shutil
from unittest import mock

import h5py
import numpy as np
import pytest
import torch
import yaml

from _torch_common import REPO
from stac_mjx_tpu import config as jconfig
from stac_mjx_tpu import io as jio
from stac_mjx_tpu import main as jmain
from stac_mjx_tpu.models import firstparty as jfirstparty
from stac_mjx_tpu.utils import batching as jbatching
from stac_mjx_tpu_torch import cli, config, io, main
from stac_mjx_tpu_torch.utils.velocity import compute_velocity_from_kinematics

CONFIGS = REPO / "configs"
N_FRAMES, N_FIT, CLIP = 40, 20, 10
OVERRIDES = [
    "model=firstparty",
    "stac=firstparty",
    "stac.data_path=rec.nwb",
    "stac.pose_mode=lockstep",
    "stac.q_solver=gn-lm",
    "stac.skip_part_opt=true",
    "stac.fk_impl=jump",
    f"stac.n_fit_frames={N_FIT}",
    f"stac.n_frames_per_clip={CLIP}",
    "stac.continuous=true",
    "stac.infer_qvels=true",
    "model.N_ITERS=2",
]
GYRO_F32_BOUND = 0.49  # rad/s: test_torch_velocity.py's float32 gyro bound
LIN = np.r_[0:3, 6:43]  # translation and joint columns of the (F, 43) qvel


def _jax_run_stac(cfg, kp, names, base_path, **patches):
    """The JAX run_stac, without its persistent compile cache (it writes
    under the home directory)."""
    with mock.patch.object(jmain.xla, "enable_xla_flags", lambda: None):
        with mock.patch.multiple(jmain, **patches) if patches else contextlib.nullcontext():
            return jmain.run_stac(cfg, kp, names, base_path=base_path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("driver")
    jcfg = jconfig.compose_config(CONFIGS, overrides=OVERRIDES)
    _, _, true_off, _ = jfirstparty.write_recording_nwb(root / "rec.nwb", jcfg, n_frames=N_FRAMES, seed=4,
                                                        base_path=REPO)
    stacs = []

    class RecordedStac(jmain.Stac):  # keeps the JAX run's Stac for the crossfade test
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            stacs.append(self)

    kp_j, names_j = jio.load_data(jcfg, base_path=root)
    (root / "jax").mkdir()
    jpaths = _jax_run_stac(jcfg, kp_j, names_j, root / "jax", Stac=RecordedStac)

    cfg = config.compose_config(CONFIGS, overrides=OVERRIDES)
    kp, names = io.load_data(cfg, base_path=root)
    (root / "port").mkdir()
    paths = main.run_stac(cfg, kp, names, base_path=root / "port", device="cpu")
    return dict(root=root, true_off=true_off, kp=kp, kp_jax=kp_j, names=names, jax=jpaths, port=paths, jax_stac=stacs[0])


def _datasets(path) -> dict:
    with h5py.File(path, "r") as f:
        return {k: (f[k].dtype, f[k].shape, f[k].compression) for k in f}


def _config_bytes(path) -> bytes:
    with h5py.File(path, "r") as f:
        return f["config"][()]


def _resid(d) -> float:
    n = d.kp_data.shape[0]
    return float(np.linalg.norm(d.marker_sites.reshape(n, -1, 3) - d.kp_data.reshape(n, -1, 3), axis=-1).mean())


def test_artifacts_have_the_jax_schema(runs):
    for i, what in enumerate(("fit", "ik")):
        jpath, path = runs["jax"][i], runs["port"][i]
        assert path.name == jpath.name
        assert _datasets(path) == _datasets(jpath), what
        assert _config_bytes(path) == _config_bytes(jpath), what


def test_fit_quality_matches_jax_f32(runs):
    (_, j), (_, t) = jio.load_stac_data(runs["jax"][0]), io.load_stac_data(runs["port"][0])
    assert t.qpos.shape == j.qpos.shape == (N_FIT, 44)
    r = {"jax": _resid(j), "port": _resid(t)}
    assert abs(r["port"] - r["jax"]) <= 0.02 * r["jax"], r
    err = {k: float(np.abs(d.offsets - runs["true_off"]).mean()) for k, d in (("jax", j), ("port", t))}
    assert err["port"] <= 1.1 * err["jax"], err


def test_ik_quality_matches_jax_f32(runs):
    (_, j), (_, t) = jio.load_stac_data(runs["jax"][1]), io.load_stac_data(runs["port"][1])
    assert t.qpos.shape == j.qpos.shape == (N_FRAMES, 44)
    assert t.qvel.shape == j.qvel.shape == (N_FRAMES, 43)  # nq - 1: ball quaternions in qpos[7:]
    r = {"jax": _resid(j), "port": _resid(t)}
    assert abs(r["port"] - r["jax"]) <= 0.02 * r["jax"], r
    # The port's qvel is its qpos' own: float32 on the driver's device
    # against float64 on the same qpos.
    want = compute_velocity_from_kinematics(torch.as_tensor(t.qpos, dtype=torch.float64).reshape(-1, CLIP, 44),
                                            dt=0.002).reshape(N_FRAMES, 43).numpy()
    np.testing.assert_allclose(t.qvel[:, LIN], want[:, LIN], rtol=1e-3, atol=0)
    assert np.abs(t.qvel[:, 3:6] - want[:, 3:6]).max() <= GYRO_F32_BOUND


def test_crossfade_and_qvel_steps_match_jax(runs):
    """The JAX ik's result before its crossfade (the JAX run's Stac.ik_only
    again, on the fit artifact's offsets), through the port's
    handle_edge_effects and qvel step, gives the JAX artifact."""
    _, fit = jio.load_stac_data(runs["jax"][0])
    _, want = jio.load_stac_data(runs["jax"][1])
    pre = runs["jax_stac"].ik_only(runs["kp_jax"], fit.offsets)
    jax_out = jbatching.handle_edge_effects(copy.deepcopy(pre), CLIP)
    got = main.handle_edge_effects(copy.deepcopy(pre), CLIP)
    for k in ("qpos", "kp_data", "xpos", "xquat", "marker_sites"):
        np.testing.assert_array_equal(getattr(jax_out, k), getattr(want, k), err_msg=k)  # the same ik ran
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
    cfg = config.compose_config(CONFIGS, overrides=OVERRIDES)
    qvel = main.infer_qvels(main.make_stac(cfg, runs["names"], device="cpu"), got.qpos, CLIP)
    assert qvel.dtype == want.qvel.dtype == np.float32
    np.testing.assert_allclose(qvel[:, LIN], want.qvel[:, LIN], rtol=1e-3, atol=0)
    assert np.abs(qvel[:, 3:6] - want.qvel[:, 3:6]).max() <= GYRO_F32_BOUND


def test_port_ik_resumes_from_a_jax_fit(runs, tmp_path):
    """skip_fit_offsets=true: the offsets, continuous flag and the config the
    ik h5 records all come from the fit h5, here another run's (whose config
    differs from the caller's in skip_fit_offsets and infer_qvels)."""
    jfit = runs["jax"][0]
    shutil.copy(jfit, tmp_path / jfit.name)
    cfg = config.compose_config(
        CONFIGS, overrides=OVERRIDES + ["stac.skip_fit_offsets=true", "stac.infer_qvels=false"]
    )
    fit, ik = main.run_stac(cfg, runs["kp"], runs["names"], base_path=tmp_path, device="cpu")
    assert fit.read_bytes() == jfit.read_bytes()  # not rewritten
    _, fd = jio.load_stac_data(jfit)
    c, d = jio.load_stac_data(ik)
    np.testing.assert_array_equal(d.offsets, fd.offsets)
    assert _config_bytes(ik) == _config_bytes(jfit)
    assert c.stac.skip_fit_offsets is False and c.stac.infer_qvels is True
    assert d.qvel.shape == (N_FRAMES, 43)  # the fit's infer_qvels=true, not the caller's false


def test_jax_ik_resumes_from_a_port_fit(runs, tmp_path):
    fit = runs["port"][0]
    shutil.copy(fit, tmp_path / fit.name)
    jcfg = jconfig.compose_config(CONFIGS, overrides=OVERRIDES + ["stac.skip_fit_offsets=true"])
    kp, names = jio.load_data(jcfg, base_path=runs["root"])
    _, ik = _jax_run_stac(jcfg, kp, names, tmp_path)
    _, fd = io.load_stac_data(fit)
    _, d = io.load_stac_data(ik)
    np.testing.assert_array_equal(d.offsets, fd.offsets)
    assert _config_bytes(ik) == _config_bytes(fit)
    assert d.qpos.shape == (N_FRAMES, 44) and d.qvel.shape == (N_FRAMES, 43)


def test_driver_errors(runs, tmp_path):
    kp, names = runs["kp"], runs["names"]
    cfg = config.compose_config(CONFIGS, overrides=OVERRIDES)
    with pytest.raises(ValueError) as want:
        jmain._require_kp_columns(kp[:, :-3], names)
    with pytest.raises(ValueError) as got:
        main.run_stac(cfg, kp[:, :-3], names, base_path=tmp_path, device="cpu")
    assert str(got.value) == str(want.value)

    # The clip length is checked before the ik runs or the fit h5 is read.
    odd = config.compose_config(CONFIGS, overrides=OVERRIDES + ["stac.n_frames_per_clip=7",
                                                                "stac.skip_fit_offsets=true"])
    with pytest.raises(ValueError) as want:
        jmain.ik_phase(None, odd, kp, tmp_path / "absent.h5", tmp_path / "ik.h5")
    with mock.patch.object(main.Stac, "ik_only", side_effect=AssertionError("ik ran")):
        with pytest.raises(ValueError) as got:
            main.run_stac(odd, kp, names, base_path=tmp_path, device="cpu")
    assert str(got.value) == str(want.value) and "clips of 7" in str(got.value)

    with pytest.raises(ValueError, match="differ from the model bundle"):
        main.run_stac(cfg, kp, names[::-1], base_path=tmp_path, device="cpu")

    moved = config.compose_config(CONFIGS, overrides=OVERRIDES + ["model.KEYPOINT_INITIAL_OFFSETS.Snout=[0, 0, 0]"])
    with pytest.raises(ValueError, match="KEYPOINT_INITIAL_OFFSETS.*export_torch_bundle"):
        main.run_stac(moved, kp, names, base_path=tmp_path, device="cpu")
    assert not list(tmp_path.iterdir())  # no artifact from any of these


def test_run_stac_and_cli_default_to_the_card(runs, tmp_path):
    cfg = config.compose_config(CONFIGS, overrides=OVERRIDES)
    if torch.cuda.is_available():
        assert main.make_stac(cfg, runs["names"], device="cuda").device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main.run_stac(cfg, runs["kp"], runs["names"], base_path=tmp_path)
    argv = ["--config-path", str(CONFIGS), "--base-path", str(runs["root"])] + OVERRIDES
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(argv)
    with pytest.raises(NotImplementedError, match="item 6"):
        cli.main(argv + ["--distributed"])
    assert not list(tmp_path.iterdir())


def test_cli_end_to_end_cpu(runs, tmp_path):
    """``--skip-xla-flags`` is accepted (a JAX command line runs unchanged)."""
    shutil.copy(runs["root"] / "rec.nwb", tmp_path / "rec.nwb")
    argv = ["--config-path", str(CONFIGS), "--base-path", str(tmp_path), "--cpu", "--skip-xla-flags"] + OVERRIDES
    assert cli.main(argv) == 0
    jcfg = jconfig.compose_config(CONFIGS, overrides=OVERRIDES)
    for name, frames in (("firstparty_fit.h5", N_FIT), ("firstparty_ik_only.h5", N_FRAMES)):
        c, d = jio.load_stac_data(tmp_path / name)
        assert c.to_dict() == jcfg.to_dict()
        assert d.qpos.shape == (frames, 44) and np.isfinite(d.qpos).all()
    assert d.qvel.shape == (N_FRAMES, 43) and np.isfinite(d.qvel).all()


def test_print_config_roundtrips_yaml(capsys):
    assert cli.main(["--config-path", str(CONFIGS), "--print-config"] + OVERRIDES) == 0
    out = yaml.safe_load(capsys.readouterr().out)
    assert out == jconfig.compose_config(CONFIGS, overrides=OVERRIDES).to_dict()
    assert cli.parse_args(["--cpu", "stac=x", "model.FTOL=1"])[1] == ["stac=x", "model.FTOL=1"]
