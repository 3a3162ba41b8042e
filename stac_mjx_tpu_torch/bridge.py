"""Carry the fitting model across from the JAX package as plain numpy arrays.

The machine with the GPU has neither jax nor (perhaps) mujoco, so the model
the JAX package compiles from MJCF on the host is frozen into a bundle of
numpy arrays (``assets/firstparty_bundle.npz``, written by
``scripts/export_torch_bundle.py``). The functions here turn such arrays,
whether loaded from the bundle or taken from live JAX objects with
``np.asarray``, into the port's topology, parameters and fit model. The tests
use the same functions to feed both packages identical parameters.

Bundle keys: ``TOPOLOGY_FIELDS`` and ``KINPARAMS_FIELDS`` (the
``KinTopology`` constructor and ``KinParams`` arrays), ``site_idxs``,
``is_regularized``, ``lb``/``ub``/``part_names`` (from the JAX package's
``_align_joint_dims``, quirks included), ``jnt_range``, ``indiv_parts``,
``trunk_kps``, ``root_kp_idx``, ``kp_names``, ``timestep`` and the model
scalars in ``MODEL_SCALARS``.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Mapping

import numpy as np
import torch

from stac_mjx_tpu_torch.models.kinematics import KinParams, KinTopology

BUNDLE_PATH = Path(__file__).resolve().parent / "assets" / "firstparty_bundle.npz"

TOPOLOGY_FIELDS = (
    "nq", "nv", "nbody", "nsite", "njnt",
    "body_parentid", "body_jntadr", "body_jntnum",
    "jnt_type", "jnt_qposadr", "jnt_bodyid", "site_bodyid",
    "body_names", "jnt_names", "site_names",
)
KINPARAMS_FIELDS = (
    "body_pos", "body_quat", "jnt_axis", "jnt_pos", "qpos0", "site_pos", "site_quat",
)
MODEL_SCALARS = ("FTOL", "N_ITERS", "N_ITER_Q", "N_SAMPLE_FRAMES", "M_REG_COEF")

_NAME_FIELDS = ("body_names", "jnt_names", "site_names")


@dataclasses.dataclass
class FitModel:
    """The compiled fitting model, as the JAX package's ``builder.FitModel`` minus mj_model."""

    topo: KinTopology
    params: KinParams
    site_idxs: np.ndarray  # keypoint site indices, in keypoint order
    is_regularized: np.ndarray  # (K, 3) 0/1 mask
    timestep: float


def load_bundle(path: str | Path = BUNDLE_PATH) -> dict[str, np.ndarray]:
    """The bundle's arrays (no pickled objects: names are unicode arrays)."""
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def topology_from_arrays(a: Mapping) -> KinTopology:
    kw = {k: a[k] for k in TOPOLOGY_FIELDS}
    for k in ("nq", "nv", "nbody", "nsite", "njnt"):
        kw[k] = int(kw[k])
    for k in _NAME_FIELDS:
        kw[k] = [str(s) for s in kw[k]]
    return KinTopology(**kw)


def params_from_arrays(
    a: Mapping, device: torch.device | str, dtype: torch.dtype
) -> KinParams:
    return KinParams(
        **{
            k: torch.as_tensor(np.array(a[k]), device=device).to(dtype)
            for k in KINPARAMS_FIELDS
        }
    )


def fit_model_from_arrays(
    a: Mapping, device: torch.device | str, dtype: torch.dtype = torch.float32
) -> FitModel:
    return FitModel(
        topo=topology_from_arrays(a),
        params=params_from_arrays(a, device, dtype),
        site_idxs=np.asarray(a["site_idxs"], np.int64),
        is_regularized=np.asarray(a["is_regularized"], np.float64),
        timestep=float(a["timestep"]),
    )
