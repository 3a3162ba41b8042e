"""Carry the fitting model across from the JAX package as plain numpy arrays.

The machine with the GPU has neither jax nor (perhaps) mujoco, so the model
the JAX package compiles from MJCF on the host is frozen into a bundle of
numpy arrays (``assets/firstparty_bundle.npz`` and ``assets/synth_data_bundle.npz``,
written by ``scripts/export_torch_bundle.py``). The functions here turn such arrays,
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

ASSETS = Path(__file__).resolve().parent / "assets"


def bundle_path(model: str) -> Path:
    """The checked-in bundle of a model config (``configs/model/<model>.yaml``)."""
    return ASSETS / f"{model}_bundle.npz"


BUNDLE_PATH = bundle_path("firstparty")

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


def resolve_device(device: torch.device | str) -> torch.device:
    """The entry points' device: the card unless the caller asks for the CPU.

    Raises when CUDA is asked for (the default) and there is no card, rather
    than dropping quietly to the CPU.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "stac_mjx_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU"
        )
    return device


def load_bundle(path: str | Path = BUNDLE_PATH) -> dict[str, np.ndarray]:
    """The bundle's arrays (no pickled objects: names are unicode arrays):
    firstparty by default, or any bundle file, e.g. ``bundle_path("synth_data")``."""
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
