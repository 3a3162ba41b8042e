"""Mocap format conversion: DANNCE .mat to NWB (ndx-pose), and a summary of
an NWB file (port of ``stac_mjx_tpu/utils/convert.py``).

The writer emits the NWB 2.x HDF5 tree that a pynwb + ndx-pose writer
produces, with h5py alone (pynwb is not a dependency), dataset for dataset
and attribute for attribute as the JAX package's writer, so either
package's ``io.load_nwb`` reads the other's files:

    /                       attrs: nwb_version, namespace, neurodata_type,
                            object_id (uuid4), .specloc (when specs cached)
    acquisition/ analysis/ general/ stimulus/{presentation,templates}
    file_create_date (1,)   identifier  session_description
    session_start_time      timestamps_reference_time
    processing/behavior/    ProcessingModule
      PoseEstimation/       ndx-pose PoseEstimation
        nodes (K,) edges (0,2) description source_software[@version]
        <node>/              PoseEstimationSeries (comments, description)
          data (F, 3)        attrs: unit, conversion, offset, resolution
          confidence (F,)    attrs: definition
          timestamps (F,)    attrs: interval, unit
          reference_frame ()

``save_nwb(..., spec_from=path)`` copies the cached ``/specifications`` of a
pynwb-written file into the new one and points the root ``.specloc`` at
them, which makes the file schema-self-describing. h5py is imported inside
the functions, as in the port's ``io.py``: a missing one raises an
ImportError that names it.
"""

from __future__ import annotations

import datetime
import uuid
from pathlib import Path

import numpy as np

from stac_mjx_tpu_torch import io

_PE_PATH = "processing/behavior/PoseEstimation"


def _typed(obj, namespace: str, neurodata_type: str, **attrs) -> None:
    """Stamp the hdmf typed-object attributes, with a fresh object_id."""
    obj.attrs["namespace"] = namespace
    obj.attrs["neurodata_type"] = neurodata_type
    obj.attrs["object_id"] = str(uuid.uuid4())
    for k, v in attrs.items():
        obj.attrs[k] = v


def save_nwb(
    nwb_path,
    data: np.ndarray,
    node_names: list,
    *,
    fps: float = 50.0,
    session_description: str = "STAC mocap keypoints",
    identifier: str = "stac-mjx-tpu",
    reference_frame: str = "world",
    unit: str = "meters",
    spec_from=None,
) -> Path:
    """Write keypoints [frames, xyz, keypoints] as an ndx-pose NWB file.

    ``spec_from`` (optional): a pynwb-written .nwb whose cached
    ``/specifications`` are copied into this file."""
    h5py = io._require("h5py")
    data = np.asarray(data, dtype=np.float64)
    if data.ndim != 3 or data.shape[1] != 3:
        raise ValueError(f"expected data [frames, xyz, keypoints], got {data.shape}")
    if data.shape[2] != len(node_names):
        raise ValueError(f"{data.shape[2]} keypoints in data but {len(node_names)} names")
    n_frames = data.shape[0]
    timestamps = np.arange(n_frames, dtype=np.float64) / fps
    now = datetime.datetime.now(datetime.timezone.utc).isoformat()

    nwb_path = Path(nwb_path)
    str_t = h5py.string_dtype(encoding="utf-8")
    with h5py.File(nwb_path, "w") as f:
        _typed(f["/"], "core", "NWBFile")
        f.attrs["nwb_version"] = "2.7.0"
        # The required NWBFile tree, empty groups included (pynwb writes them).
        for g in ("acquisition", "analysis", "general", "stimulus/presentation", "stimulus/templates"):
            f.create_group(g)
        f.create_dataset("file_create_date", data=np.array([now], dtype=object), dtype=str_t)
        f.create_dataset("identifier", data=identifier, dtype=str_t)
        f.create_dataset("session_description", data=session_description, dtype=str_t)
        f.create_dataset("session_start_time", data="1970-01-01T00:00:00+00:00", dtype=str_t)
        f.create_dataset("timestamps_reference_time", data="1970-01-01T00:00:00+00:00", dtype=str_t)

        behavior = f.create_group("processing/behavior")
        _typed(behavior, "core", "ProcessingModule", description="processed behavioral data")
        pe = behavior.create_group("PoseEstimation")
        _typed(pe, "ndx-pose", "PoseEstimation")
        pe.create_dataset("nodes", data=np.array(node_names, dtype=object), dtype=str_t)
        pe.create_dataset("edges", data=np.zeros((0, 2), dtype=np.uint8))
        pe.create_dataset("description", data="keypoint pose estimation", dtype=str_t)
        sw = pe.create_dataset("source_software", data="stac-mjx-tpu", dtype=str_t)
        sw.attrs["version"] = ""
        for k, name in enumerate(node_names):
            g = pe.create_group(str(name))
            _typed(g, "ndx-pose", "PoseEstimationSeries", comments="no comments", description=f"keypoint {name}")
            d = g.create_dataset("data", data=data[:, :, k])
            d.attrs["unit"] = unit
            d.attrs["conversion"] = np.float64(1.0)
            d.attrs["offset"] = np.float64(0.0)
            d.attrs["resolution"] = np.float64(-1.0)
            c = g.create_dataset("confidence", data=np.ones(n_frames, dtype=np.float64))
            c.attrs["definition"] = "confidence"
            t = g.create_dataset("timestamps", data=timestamps)
            t.attrs["interval"] = np.int64(1)
            t.attrs["unit"] = "seconds"
            g.create_dataset("reference_frame", data=reference_frame, dtype=str_t)

        if spec_from is not None:
            with h5py.File(spec_from, "r") as donor:
                if "specifications" not in donor:
                    raise ValueError(f"{spec_from} has no /specifications group to copy")
                donor.copy("specifications", f)
            f.attrs[".specloc"] = f["specifications"].ref
    return nwb_path


def mat_to_nwb(
    mat_path,
    nwb_path,
    names_path=None,
    node_names: list | None = None,
    *,
    fps: float = 50.0,
    **kwargs,
) -> Path:
    """Convert a DANNCE .mat recording ('pred' key, in mocap units) to NWB.

    Keypoint names come from an optional label3d ``names_path``
    (``joint_names``), or an explicit ``node_names`` list, else
    ``kp_0 .. kp_{K-1}``. Values are written unscaled: MOCAP_SCALE_FACTOR
    applies when the file is loaded. Other keyword arguments (``spec_from``,
    ``unit``, ...) go to :func:`save_nwb`."""
    data, mat_names = io.load_dannce(mat_path, names_filename=names_path)
    data = np.asarray(data, dtype=np.float64)
    names = node_names or mat_names
    if names is None:
        names = [f"kp_{i}" for i in range(data.shape[2])]
    return save_nwb(nwb_path, data, list(names), fps=fps, **kwargs)


def describe_nwb(path) -> dict:
    """Summary of an ndx-pose NWB file: {path, nodes, series: {node: {shape,
    duration_s}}, n_frames}; also printed as a short tree."""
    h5py = io._require("h5py")
    with h5py.File(path, "r") as f:
        pe = f[_PE_PATH]
        nodes = [n.decode() if isinstance(n, bytes) else str(n) for n in pe["nodes"][:]]
        info = {"path": str(path), "nodes": nodes, "series": {}}
        for name in nodes:
            g = pe[name]
            ts = g["timestamps"][:] if "timestamps" in g else None
            info["series"][name] = {
                "shape": tuple(g["data"].shape),
                "duration_s": float(ts[-1] - ts[0]) if ts is not None and len(ts) else 0.0,
            }
        info["n_frames"] = info["series"][nodes[0]]["shape"][0] if nodes else 0
    print(f"{info['path']}: {len(nodes)} keypoints, {info['n_frames']} frames")
    for name, s in info["series"].items():
        print(f"  {name}: data{s['shape']} ({s['duration_s']:.2f}s)")
    return info
