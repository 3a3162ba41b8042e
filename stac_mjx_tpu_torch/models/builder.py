"""Compile a fitting model from MJCF with mujoco (port of ``stac_mjx_tpu/models/builder.py``).

mujoco is used as a compiler on the host, as in the JAX package:
``MjSpec.from_file``, one site per keypoint, the uniform rescale, then
``compile()``. The compiled model's arrays are read once into the port's
``KinTopology`` and parameters; no mujoco object reaches the solves.
``bundle_arrays`` returns what ``scripts/export_torch_bundle.py`` writes
into a bundle, with no JAX: the ``Stac``'s derived arrays come from
``models/setup.py``.

mujoco is imported inside the functions that need it (``import_mujoco``),
so the module imports where mujoco is missing, as on the card's machine;
``bridge.bundle_for_config`` calls in here only when no checked-in bundle
serves the config.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Mapping

import numpy as np
import torch

from stac_mjx_tpu_torch.bridge import (
    KINPARAMS_FIELDS,
    MODEL_SCALARS,
    TOPOLOGY_FIELDS,
    FitModel,
    fit_model_from_arrays,
)
from stac_mjx_tpu_torch.models.kinematics import KinTopology
from stac_mjx_tpu_torch.models.rescale import scale_spec
from stac_mjx_tpu_torch.models.setup import model_setup


def _ensure_headless_gl() -> None:
    """Default to EGL off-screen rendering when no display is available.

    mujoco picks its GL backend when it is first imported, so this runs
    before every import of it in the port (``import_mujoco``)."""
    if "MUJOCO_GL" not in os.environ and not os.environ.get("DISPLAY"):
        os.environ["MUJOCO_GL"] = "egl"


def import_mujoco():
    """The mujoco module, with the headless GL default set first."""
    _ensure_headless_gl()
    import mujoco

    return mujoco


def parse_pos(pos) -> list[float]:
    """A position given as "x y z" or as a sequence, as floats."""
    if isinstance(pos, str):
        return [float(p) for p in pos.split()]
    return [float(p) for p in pos]


def resolve_mjcf(model_cfg: Mapping, base_path: str | Path | None = None) -> Path:
    """The model's MJCF file, resolved as the JAX driver does: base_path /
    MJCF_PATH (base_path defaults to the working directory), then
    ``utils.assets.resolve_asset``. The path may not exist."""
    from stac_mjx_tpu_torch.utils.assets import resolve_asset

    base_path = Path(base_path) if base_path is not None else Path.cwd()
    xml = base_path / model_cfg["MJCF_PATH"]
    return xml if xml.exists() else resolve_asset(model_cfg["MJCF_PATH"], base_path)


# Mass and inertia bound of a model whose meshes were pruned: above mujoco's
# mjMINVAL (1e-15), below any body mass a model is built with.
_PRUNED_MASS_BOUND = 1e-12


def _prune_missing_meshes(spec, model_dir: Path) -> None:
    """Drop mesh assets whose files don't exist, and the geoms that use them.

    Some model trees ship MJCFs that name meshes never committed (the
    fruitfly's head_body.obj); meshes are visual only for STAC, so pruning
    them keeps the kinematics and lets the spec compile. A body whose mass
    came from its meshes alone (every moving body of a fly MJCF shipped
    without its meshes) would then be massless, which mujoco refuses to
    compile: where the MJCF sets no mass or inertia bound, a bound of
    _PRUNED_MASS_BOUND is set, which changes no body frame."""
    meshdir = Path(spec.meshdir) if spec.meshdir else Path(".")
    if not meshdir.is_absolute():
        meshdir = model_dir / meshdir
    missing = {mesh.name for mesh in spec.meshes if mesh.file and not (meshdir / mesh.file).exists()}
    if not missing:
        return
    mujoco = import_mujoco()
    for body in spec.bodies:
        for geom in list(body.geoms):
            if geom.type == mujoco.mjtGeom.mjGEOM_MESH and geom.meshname in missing:
                spec.delete(geom)
    for mesh in list(spec.meshes):
        if mesh.name in missing:
            spec.delete(mesh)
    spec.compiler.boundmass = spec.compiler.boundmass or _PRUNED_MASS_BOUND
    spec.compiler.boundinertia = spec.compiler.boundinertia or _PRUNED_MASS_BOUND


def build_body_spec(xml_path: str | Path, cfg_model: Mapping):
    """A fresh MjSpec with one site per keypoint on its mapped body, at its
    initial offset (group 3), then uniformly rescaled by SCALE_FACTOR."""
    mujoco = import_mujoco()
    spec = mujoco.MjSpec.from_file(str(xml_path))
    _prune_missing_meshes(spec, Path(xml_path).parent)
    marker_size = float(cfg_model["MARKER_SIZE"])
    for key, body_name in cfg_model["KEYPOINT_MODEL_PAIRS"].items():
        spec.body(body_name).add_site(
            name=key,
            size=[marker_size] * 3,
            rgba=(0, 0, 0, 0.8),
            pos=parse_pos(cfg_model["KEYPOINT_INITIAL_OFFSETS"][key]),
            group=3,
        )
    return scale_spec(spec, float(cfg_model["SCALE_FACTOR"]))


def extract_model(mj_model) -> tuple[KinTopology, dict[str, np.ndarray]]:
    """A compiled MjModel as the port's topology and its KINPARAMS_FIELDS
    arrays, in the model's own float64."""
    topo = KinTopology(
        nq=mj_model.nq,
        nv=mj_model.nv,
        nbody=mj_model.nbody,
        nsite=mj_model.nsite,
        njnt=mj_model.njnt,
        body_parentid=mj_model.body_parentid,
        body_jntadr=mj_model.body_jntadr,
        body_jntnum=mj_model.body_jntnum,
        jnt_type=mj_model.jnt_type,
        jnt_qposadr=mj_model.jnt_qposadr,
        jnt_bodyid=mj_model.jnt_bodyid,
        site_bodyid=mj_model.site_bodyid,
        body_names=[mj_model.body(i).name for i in range(mj_model.nbody)],
        jnt_names=[mj_model.joint(i).name for i in range(mj_model.njnt)],
        site_names=[mj_model.site(i).name for i in range(mj_model.nsite)],
    )
    return topo, {k: np.asarray(getattr(mj_model, k), np.float64) for k in KINPARAMS_FIELDS}


def _compile(xml_path: str | Path, cfg_model: Mapping):
    """(MjModel, keypoint site indices in KEYPOINT_MODEL_PAIRS order)."""
    mujoco = import_mujoco()
    mj_model = build_body_spec(xml_path, cfg_model).compile()
    site_idxs = np.array(
        [mujoco.mj_name2id(mj_model, mujoco.mjtObj.mjOBJ_SITE, name) for name in cfg_model["KEYPOINT_MODEL_PAIRS"].keys()],
        dtype=np.int32,
    )
    return mj_model, site_idxs


def _arrays(xml_path: str | Path, model_cfg) -> dict[str, np.ndarray]:
    """The bundle arrays of the model compiled from xml_path under model_cfg."""
    mj_model, site_idxs = _compile(xml_path, model_cfg)
    topo, kinparams = extract_model(mj_model)
    out: dict[str, np.ndarray] = {}
    for k in TOPOLOGY_FIELDS:
        v = getattr(topo, k)
        out[k] = np.array(v, dtype=str) if isinstance(v, list) else np.asarray(v)
    out.update(kinparams)
    jnt_range = np.asarray(mj_model.jnt_range, np.float64)
    setup = model_setup(model_cfg, {"jnt_type": topo.jnt_type, "jnt_range": jnt_range, "jnt_names": topo.jnt_names})
    out.update(
        site_idxs=site_idxs,
        is_regularized=setup["is_regularized"],
        lb=setup["lb"],
        ub=setup["ub"],
        part_names=np.array(setup["part_names"], dtype=str),
        jnt_range=jnt_range,
        indiv_parts=setup["indiv_parts"],
        trunk_kps=setup["trunk_kps"],
        root_kp_idx=np.asarray(setup["root_kp_idx"]),
        kp_names=np.array(setup["kp_names"], dtype=str),
        timestep=np.asarray(mj_model.opt.timestep, np.float64),
    )
    for k in MODEL_SCALARS:
        out[k] = np.asarray(model_cfg[k])
    out["model_config"] = np.array(json.dumps(model_cfg.to_dict()))
    return out


def bundle_arrays(cfg, base_path: str | Path | None = None) -> dict[str, np.ndarray]:
    """The bundle of a composed config's model (``cfg.model``), compiled from
    its MJCF (``resolve_mjcf``): the keys and values that
    ``scripts/export_torch_bundle.py`` writes, computed without JAX."""
    return _arrays(resolve_mjcf(cfg.model, base_path), cfg.model)


def body_inertia(cfg, base_path: str | Path | None = None) -> tuple[np.ndarray, np.ndarray]:
    """(body_mass (nbody,), body_ipos (nbody, 3)), float64, of a composed
    config's fitting model, compiled as ``bundle_arrays`` compiles it
    (keypoint sites, SCALE_FACTOR rescale): the inputs of
    ``kinematics.subtree_com``. The bundles do not carry them; for hosts
    without mujoco the checked-in ``assets/firstparty_inertia.npz`` holds
    the first-party model's (``scripts/export_torch_inertia.py`` writes it)."""
    mj_model, _ = _compile(resolve_mjcf(cfg.model, base_path), cfg.model)
    return np.asarray(mj_model.body_mass, np.float64), np.asarray(mj_model.body_ipos, np.float64)


def build_fit_model(
    xml_path: str | Path, cfg_model, device: torch.device | str = "cuda", dtype: torch.dtype = torch.float32
) -> tuple[FitModel, np.ndarray]:
    """The fitting model compiled from an MJCF, as the ``Stac`` takes it
    (``bridge.fit_model_from_arrays`` of the bundle arrays), its parameters
    on ``device`` in ``dtype``, and the compiled (njnt, 2) ``jnt_range``."""
    arrays = _arrays(xml_path, cfg_model)
    return fit_model_from_arrays(arrays, device, dtype), arrays["jnt_range"]
