"""Data I/O: mocap loaders (.mat/.nwb/.h5/.csv) and the HDF5 result round
trip (port of ``stac_mjx_tpu/io.py``).

Same dispatch on the file suffix, keypoint reordering into
KEYPOINT_MODEL_PAIRS key order, MOCAP_SCALE_FACTOR scaling and flattening,
and the same HDF5 schema (dataset names, ``S`` string dtypes, gzip, the
config embedded as YAML bytes), so artifacts of either package load in the
other. h5py, scipy and PyYAML are imported by the functions that need them;
a missing one raises an ImportError that names it.
"""

from __future__ import annotations

import importlib
from dataclasses import asdict, dataclass, field
from pathlib import Path

import numpy as np

from stac_mjx_tpu_torch.config import ConfigNode, config_from_dict


@dataclass
class StacData:
    """STAC output container; the fields of the JAX package's ``io.StacData``."""

    qpos: np.ndarray  # root position/quaternion + joint angles
    xpos: np.ndarray  # body positions
    xquat: np.ndarray  # body quaternions
    marker_sites: np.ndarray  # marker site positions
    offsets: np.ndarray  # marker site offsets
    kp_data: np.ndarray  # keypoint data
    names_qpos: list  # per-qpos-dim joint names
    names_xpos: list  # body names
    kp_names: list  # keypoint names
    qvel: np.ndarray = field(default_factory=lambda: np.array([]))

    def as_dict(self) -> dict:
        """Convert to a plain dict."""
        return asdict(self)


_PIP_NAME = {"yaml": "PyYAML", "scipy.io": "scipy"}


def _require(module: str):
    """Import a host-side dependency, or raise an ImportError that names it."""
    try:
        return importlib.import_module(module)
    except ImportError as e:
        pkg = _PIP_NAME.get(module, module)
        raise ImportError(
            f"stac_mjx_tpu_torch.io needs {pkg} for this step ({module} is not "
            f"importable); install it with `pip install {pkg}`"
        ) from e


def load_data(cfg, base_path: Path | None = None):
    """Load mocap data, reorder to model order, scale, and flatten.

    Returns (kp_data, sorted keypoint names): kp_data a numpy float32
    (F, 3K) array, bitwise equal to the JAX package's (float64 products,
    then one rounding to float32).
    """
    from stac_mjx_tpu_torch.utils.assets import resolve_asset

    if base_path is None:
        base_path = Path.cwd()

    file_path = Path(base_path) / cfg.stac.data_path
    if not file_path.exists():
        file_path = resolve_asset(cfg.stac.data_path, base_path)
    if file_path.suffix == ".mat":
        label3d_path = cfg.model.get("KP_NAMES_LABEL3D_PATH", None)
        if label3d_path is not None:
            label3d_path = Path(base_path) / label3d_path
        data, kp_names = load_dannce(str(file_path), names_filename=label3d_path)
    elif file_path.suffix == ".nwb":
        data, kp_names = load_nwb(file_path)
    elif file_path.suffix == ".h5":
        data, kp_names = load_h5(file_path)
    elif file_path.suffix == ".csv":
        data, kp_names = load_csv(file_path, kp_names=cfg.model.get("KP_NAMES", None))
    else:
        raise ValueError(
            f"cannot load '{file_path.suffix}' mocap data — supported "
            f"formats: .mat (DANNCE), .nwb, .h5, .csv"
        )

    kp_names = kp_names or cfg.model.get("KP_NAMES", None)
    if kp_names is None:
        raise ValueError(
            "no keypoint names available: the data file carries none and "
            "the model config has no KP_NAMES — set cfg.model.KP_NAMES to "
            "the ordered name list matching the data columns"
        )
    if len(kp_names) != data.shape[2]:
        raise ValueError(
            f"{len(kp_names)} keypoint names vs {data.shape[2]} keypoints "
            f"in the data — the name list must match the data's keypoint "
            f"axis exactly"
        )

    model_inds = [kp_names.index(src) for src in cfg.model.KEYPOINT_MODEL_PAIRS.keys()]
    sorted_kp_names = [kp_names[i] for i in model_inds]

    data = data * cfg.model.MOCAP_SCALE_FACTOR
    data = np.asarray(data[:, :, model_inds])
    data = np.transpose(data, (0, 2, 1))  # [F, xyz, K] -> [F, K, xyz]
    data = data.reshape(data.shape[0], -1)
    return np.array(data, dtype=np.float32), sorted_kp_names


def load_dannce(filename, names_filename=None):
    """DANNCE .mat loader: 'pred' key, [frames, xyz, keypoints]; optional
    label3d file of joint names."""
    spio = _require("scipy.io")
    node_names = None
    if names_filename is not None:
        mat = spio.loadmat(str(names_filename))
        node_names = [item[0] for sublist in mat["joint_names"] for item in sublist]
    data = _check_keys(spio.loadmat(filename, struct_as_record=False, squeeze_me=True), spio)["pred"]
    return data, node_names


def load_nwb(filename):
    """NWB loader via h5py (ndx-pose ``processing/behavior/PoseEstimation``):
    [frames, xyz, keypoints] + node names."""
    h5py = _require("h5py")
    with h5py.File(filename, "r") as f:
        pe = f["processing/behavior/PoseEstimation"]
        node_names = [n.decode() if isinstance(n, bytes) else str(n) for n in pe["nodes"][:]]
        data = np.stack([pe[name]["data"][:] for name in node_names], axis=-1)
    return data, node_names


def load_h5(filename):
    """Generic .h5 loader: 'tracks' dataset [F, 1, xyz, K] -> [F, xyz, K]; no names."""
    h5py = _require("h5py")
    with h5py.File(filename, "r") as f:
        data = f["tracks"][()]
    data = np.squeeze(np.array(data), axis=1)
    data = np.transpose(data, (0, 2, 1))
    return data, None


def load_csv(filename, kp_names: list | None = None):
    """CSV loader: per-keypoint ``<name>_x/_y/_z`` columns. Names come from
    ``kp_names`` when given, else from the header's ``*_x`` columns in file
    order. Returns [frames, xyz, keypoints] + names."""
    import csv

    with open(filename, newline="") as fh:
        reader = csv.reader(fh)
        header = next(reader)
        rows = [row for row in reader if row]
    col = {name: i for i, name in enumerate(header)}
    if kp_names is None:
        kp_names = [c[:-2] for c in header if c.endswith("_x")]
    missing = [f"{kp}{suf}" for kp in kp_names for suf in ("_x", "_y", "_z") if f"{kp}{suf}" not in col]
    if missing:
        raise ValueError(f"CSV is missing keypoint columns: {missing}")
    # Only the keypoint columns are converted (extra columns may be text).
    flat_cols = [col[f"{kp}{suf}"] for kp in kp_names for suf in ("_x", "_y", "_z")]
    data = np.asarray([[row[c] for c in flat_cols] for row in rows], dtype=np.float64).reshape(
        len(rows), len(kp_names), 3
    )  # [F, K, xyz]
    return np.transpose(data, (0, 2, 1)), list(kp_names)


def _check_keys(d: dict, spio) -> dict:
    for key in d:
        if isinstance(d[key], spio.matlab.mat_struct):
            d[key] = _todict(d[key], spio)
    return d


def _todict(matobj, spio) -> dict:
    result = {}
    for name in matobj._fieldnames:
        elem = matobj.__dict__[name]
        result[name] = _todict(elem, spio) if isinstance(elem, spio.matlab.mat_struct) else elem
    return result


def save_data_to_h5(
    config,
    kp_names,
    names_qpos,
    names_xpos,
    kp_data,
    marker_sites,
    offsets,
    qpos,
    xpos,
    xquat,
    qvel,
    file_path,
) -> None:
    """Save config + STAC outputs to HDF5, in the JAX package's schema."""
    h5py = _require("h5py")
    if isinstance(config, ConfigNode):
        _require("yaml")
        config_yaml = config.to_yaml()
    elif isinstance(config, dict):
        config_yaml = _require("yaml").safe_dump(config, sort_keys=False)
    else:
        config_yaml = str(config)
    with h5py.File(file_path, "w") as f:
        f.create_dataset("config", data=np.bytes_(config_yaml))
        f.create_dataset("kp_names", data=np.array(kp_names, dtype="S"))
        f.create_dataset("names_qpos", data=np.array(names_qpos, dtype="S"))
        f.create_dataset("names_xpos", data=np.array(names_xpos, dtype="S"))
        f.create_dataset("kp_data", data=kp_data, compression="gzip")
        f.create_dataset("marker_sites", data=marker_sites, compression="gzip")
        f.create_dataset("offsets", data=offsets, compression="gzip")
        f.create_dataset("qpos", data=qpos, compression="gzip")
        f.create_dataset("qvel", data=qvel, compression="gzip")
        f.create_dataset("xpos", data=xpos, compression="gzip")
        f.create_dataset("xquat", data=xquat, compression="gzip")


def load_stac_data(file_path) -> tuple[ConfigNode, StacData]:
    """Load config + STAC outputs from HDF5 (inverse of save_data_to_h5)."""
    h5py = _require("h5py")
    yaml = _require("yaml")
    with h5py.File(file_path, "r") as f:
        config = config_from_dict(yaml.safe_load(f["config"][()].decode("utf-8")))
        stac_data = StacData(
            kp_names=[n.decode("utf-8") for n in f["kp_names"]],
            names_qpos=[n.decode("utf-8") for n in f["names_qpos"]],
            names_xpos=[n.decode("utf-8") for n in f["names_xpos"]],
            kp_data=f["kp_data"][()],
            marker_sites=f["marker_sites"][()],
            offsets=f["offsets"][()],
            qpos=f["qpos"][()],
            qvel=f["qvel"][()],
            xpos=f["xpos"][()],
            xquat=f["xquat"][()],
        )
    return config, stac_data
