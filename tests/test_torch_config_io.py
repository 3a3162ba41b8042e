"""The port's config composition and data I/O against the JAX package's:
composed configs equal, the same override errors, every mocap format loaded
to bitwise-equal float32 arrays, and h5 artifacts of one schema that each
package reads from the other."""

import csv

import h5py
import numpy as np
import pytest
import scipy.io as spio

from _torch_common import REPO
from stac_mjx_tpu import config as jconfig
from stac_mjx_tpu import io as jio
from stac_mjx_tpu.models import firstparty as jfirstparty
from stac_mjx_tpu_torch import config, io

CONFIGS = REPO / "configs"
BASE = ["model=firstparty", "stac=firstparty"]


@pytest.mark.parametrize(
    "overrides",
    [
        [],  # the root config's defaults (stac=demo, model=rodent)
        BASE,
        BASE + ["stac.pose_mode=lockstep", "stac.q_solver=gn-lm", "model.N_ITERS=2", "stac.continuous=true"],
        BASE + ["stac.mujoco.iterations=3", "+model.KEYPOINT_COLOR_PAIRS.Snout=[1, 0, 0, 1]", "model.KP_NAMES="],
        ["model=synth_data", "stac=stac_synth_data", "hydra/job_logging=disabled", "stac.spd_impl=xla"],
    ],
)
def test_compose_config_matches_jax(overrides):
    want = jconfig.compose_config(CONFIGS, overrides=overrides)
    got = config.compose_config(CONFIGS, overrides=overrides)
    assert got.to_dict() == want.to_dict()
    assert got.to_yaml() == want.to_yaml()


@pytest.mark.parametrize(
    "overrides",
    [
        ["stac.n_fit_frame=3"],  # typo in a schema key
        ["+stac.n_fit_frames=3"],  # '+' on an existing key
        ["model.NOT_A_KEY=1"],  # unknown, without '+'
        ["+model.NOT_A_KEY=1"],  # added, then rejected by the schema
        ["+extra=1"],  # unknown top-level group
        ["stac.mujoco.nope=1"],
    ],
)
def test_compose_config_rejects_what_jax_rejects(overrides):
    with pytest.raises(ValueError) as want:
        jconfig.compose_config(CONFIGS, overrides=BASE + overrides)
    with pytest.raises(ValueError) as got:
        config.compose_config(CONFIGS, overrides=BASE + overrides)
    assert str(got.value) == str(want.value)


def test_schema_equals_jax():
    import dataclasses

    for name in ("ModelConfig", "MujocoConfig", "StacConfig", "Config"):
        a, b = dataclasses.fields(getattr(config, name)), dataclasses.fields(getattr(jconfig, name))
        assert [(f.name, f.default, f.default_factory is dataclasses.MISSING) for f in a] == [
            (f.name, f.default if f.default is not jconfig._MISSING else config._MISSING,
             f.default_factory is dataclasses.MISSING) for f in b
        ], name
    d = jconfig.compose_config(CONFIGS, overrides=BASE).to_dict()
    assert config.config_from_dict(d).to_dict() == jconfig.config_from_dict(d).to_dict()
    with pytest.raises(ValueError, match="missing required key: stac.data_path"):
        config.config_from_dict({"model": d["model"], "stac": {k: v for k, v in d["stac"].items() if k != "data_path"}})


# ------------------------------------------------------------------ loaders

N_FRAMES = 12


@pytest.fixture(scope="module")
def recordings(tmp_path_factory):
    """One firstparty recording in every format, in mocap units (mm)."""
    d = tmp_path_factory.mktemp("recordings")
    cfg = jconfig.compose_config(CONFIGS, overrides=BASE)
    kp, names, _, _ = jfirstparty.write_recording_nwb(d / "rec.nwb", cfg, n_frames=N_FRAMES, seed=2, base_path=REPO)
    mm = np.asarray(kp, np.float64).reshape(N_FRAMES, -1, 3) / cfg.model.MOCAP_SCALE_FACTOR  # [F, K, xyz]
    pred = np.transpose(mm, (0, 2, 1))  # [F, xyz, K]
    perm = np.random.default_rng(0).permutation(len(names))  # file order differs from model order
    spio.savemat(d / "rec64.mat", {"pred": pred})
    spio.savemat(d / "rec32.mat", {"pred": pred.astype(np.float32)})
    spio.savemat(d / "shuffled.mat", {"pred": pred[:, :, perm]})
    label3d = np.empty((len(names), 1), dtype=object)
    for i, k in enumerate(perm):
        label3d[i, 0] = np.array([names[k]])
    spio.savemat(d / "names.mat", {"joint_names": label3d})
    with h5py.File(d / "rec.h5", "w") as f:
        f.create_dataset("tracks", data=mm[:, None])  # [F, 1, K, xyz]: the loader transposes it
    with open(d / "rec.csv", "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["frame"] + [f"{names[k]}_{c}" for k in perm for c in "xyz"])
        for i, row in enumerate(mm[:, perm]):
            w.writerow([i] + [repr(float(v)) for v in row.reshape(-1)])
    return d


@pytest.mark.parametrize(
    "data_path,model_overrides",
    [
        ("rec.nwb", []),
        ("rec64.mat", []),
        ("rec32.mat", []),
        ("shuffled.mat", ["model.KP_NAMES_LABEL3D_PATH=names.mat"]),
        ("rec.h5", []),
        ("rec.csv", []),  # columns gathered by model.KP_NAMES
        ("rec.csv", ["model.KP_NAMES=null"]),  # names from the header, in file order
    ],
)
def test_load_data_is_bitwise(recordings, data_path, model_overrides):
    overrides = BASE + [f"stac.data_path={data_path}"] + model_overrides
    want, want_names = jio.load_data(jconfig.compose_config(CONFIGS, overrides=overrides), base_path=recordings)
    got, got_names = io.load_data(config.compose_config(CONFIGS, overrides=overrides), base_path=recordings)
    want = np.asarray(want)
    assert isinstance(got, np.ndarray) and got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (N_FRAMES, 69)
    np.testing.assert_array_equal(got, want)
    assert got_names == want_names == list(jfirstparty.KEYPOINTS)


def test_load_data_errors_match(recordings):
    for overrides in (["stac.data_path=rec.txt"], ["stac.data_path=rec.h5", "model.KP_NAMES=null"]):
        with pytest.raises(ValueError) as want:
            jio.load_data(jconfig.compose_config(CONFIGS, overrides=BASE + overrides), base_path=recordings)
        with pytest.raises(ValueError) as got:
            io.load_data(config.compose_config(CONFIGS, overrides=BASE + overrides), base_path=recordings)
        assert str(got.value) == str(want.value)


# -------------------------------------------------------------- artifacts


def _stac_data(cls, seed=0, lean=False):
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return cls(
        qpos=f32(20, 44),
        xpos=np.zeros((0,), np.float32) if lean else f32(20, 19, 3),
        xquat=np.zeros((0,), np.float32) if lean else f32(20, 19, 4),
        marker_sites=np.zeros((0,), np.float32) if lean else f32(20, 23, 3),
        offsets=f32(23, 3),
        kp_data=f32(20, 69),
        names_qpos=[f"joint_{i}" for i in range(44)],
        names_xpos=[f"body_{i}" for i in range(19)],
        kp_names=list(jfirstparty.KEYPOINTS),
        qvel=f32(20, 43),
    )


def _describe(path) -> dict:
    """Every dataset: dtype, shape, compression and bytes."""
    with h5py.File(path, "r") as f:
        return {k: (f[k].dtype, f[k].shape, f[k].compression, f[k][()].tobytes()) for k in f}


@pytest.mark.parametrize("lean", [False, True], ids=["full", "lean"])
def test_save_data_to_h5_matches_jax_schema(tmp_path, lean):
    overrides = BASE + ["stac.infer_qvels=true"]
    jcfg, cfg = (m.compose_config(CONFIGS, overrides=overrides) for m in (jconfig, config))
    jio.save_data_to_h5(config=jcfg, file_path=tmp_path / "jax.h5", **_stac_data(jio.StacData, lean=lean).as_dict())
    io.save_data_to_h5(config=cfg, file_path=tmp_path / "port.h5", **_stac_data(io.StacData, lean=lean).as_dict())
    want, got = _describe(tmp_path / "jax.h5"), _describe(tmp_path / "port.h5")
    assert sorted(got) == sorted(want) == sorted(
        ["config", "kp_names", "names_qpos", "names_xpos", "kp_data", "marker_sites", "offsets", "qpos", "qvel",
         "xpos", "xquat"]
    )
    assert got == want
    # A dict config and a YAML string embed as the JAX writer embeds them.
    for c in (jcfg.to_dict(), jcfg.to_yaml()):
        jio.save_data_to_h5(config=c, file_path=tmp_path / "jax2.h5", **_stac_data(jio.StacData).as_dict())
        io.save_data_to_h5(config=c, file_path=tmp_path / "port2.h5", **_stac_data(io.StacData).as_dict())
        assert _describe(tmp_path / "port2.h5")["config"] == _describe(tmp_path / "jax2.h5")["config"]


def test_each_package_reads_the_others_artifact(tmp_path):
    jcfg = jconfig.compose_config(CONFIGS, overrides=BASE + ["stac.continuous=true"])
    cfg = config.compose_config(CONFIGS, overrides=BASE + ["stac.continuous=true"])
    jio.save_data_to_h5(config=jcfg, file_path=tmp_path / "jax.h5", **_stac_data(jio.StacData, 1).as_dict())
    io.save_data_to_h5(config=cfg, file_path=tmp_path / "port.h5", **_stac_data(io.StacData, 1).as_dict())
    for path in (tmp_path / "jax.h5", tmp_path / "port.h5"):
        (jc, jd), (c, d) = jio.load_stac_data(path), io.load_stac_data(path)
        assert isinstance(d, io.StacData) and isinstance(c, config.ConfigNode)
        assert c.to_dict() == jc.to_dict() == jcfg.to_dict()
        for k, v in jd.as_dict().items():
            g = d.as_dict()[k]
            if isinstance(v, list):
                assert g == v, k
            else:
                assert g.dtype == v.dtype, k
                np.testing.assert_array_equal(g, v, err_msg=k)


def test_missing_host_dependency_is_named(monkeypatch, tmp_path):
    import sys

    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="needs h5py"):
        io.load_stac_data(tmp_path / "x.h5")
    monkeypatch.setitem(sys.modules, "scipy.io", None)
    with pytest.raises(ImportError, match="needs scipy"):
        io.load_dannce(tmp_path / "x.mat")
