"""Carry the fitting model to the PyTorch port as plain numpy arrays.

The machine with the GPU has neither jax nor mujoco, so a compiled fitting
model travels as a bundle of numpy arrays (``assets/firstparty_bundle.npz``
and ``assets/synth_data_bundle.npz``, written by
``scripts/export_torch_bundle.py``, or by ``models/builder.bundle_arrays``
where mujoco imports). The functions here turn such arrays, whether loaded
from a bundle, built by the port's builder or taken from live JAX objects
with ``np.asarray``, into the port's topology, parameters and fit model, and
find the model of a config (``bundle_for_config``). The tests use the same
functions to feed both packages identical parameters.

Bundle keys: ``TOPOLOGY_FIELDS`` and ``KINPARAMS_FIELDS`` (the
``KinTopology`` constructor and ``KinParams`` arrays), ``site_idxs``,
``is_regularized``, ``lb``/``ub``/``part_names`` (``_align_joint_dims``,
quirks included), ``jnt_range``, ``indiv_parts``, ``trunk_kps``,
``root_kp_idx``, ``kp_names``, ``timestep``, the model scalars in
``MODEL_SCALARS`` and ``model_config``: the composed ``cfg.model`` the
bundle was made from, as a JSON string. The ``Stac`` derives the set-up
arrays (``lb`` ... ``is_regularized``) from its model config
(``models/setup.py``); the bundle keeps them for the record.
"""

from __future__ import annotations

import dataclasses
import json
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


# The first-party fitting model's body masses and inertial frames
# (``builder.body_inertia``), for ``kinematics.subtree_com``.
INERTIA_PATH = ASSETS / "firstparty_inertia.npz"


def load_inertia() -> tuple[np.ndarray, np.ndarray]:
    """(body_mass, body_ipos) of the first-party model from ``INERTIA_PATH``."""
    with np.load(INERTIA_PATH, allow_pickle=False) as z:
        return z["body_mass"], z["body_ipos"]


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
# The model keys that shape the compiled arrays: a bundle serves every config
# that equals its recorded one on these (the Stac applies the other keys).
COMPILED_KEYS = ("MJCF_PATH", "KEYPOINT_MODEL_PAIRS", "KEYPOINT_INITIAL_OFFSETS", "SCALE_FACTOR", "MARKER_SIZE")
# The mujoco release that compiled the checked-in bundles: the port's builder
# reproduces them bitwise under it.
BUNDLE_MUJOCO_VERSION = "3.10.0"

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


def _compiled_view(model: Mapping) -> dict:
    """A model config's COMPILED_KEYS as the builder reads them: the MJCF by
    file name, the keypoint pairs in order, each keypoint's initial offset
    as floats, the scales as floats (absent keys take the schema's defaults)."""
    from stac_mjx_tpu_torch.models.builder import parse_pos

    pairs = list(dict(model.get("KEYPOINT_MODEL_PAIRS") or {}).items())
    offsets = dict(model.get("KEYPOINT_INITIAL_OFFSETS") or {})
    return {
        "MJCF_PATH": Path(str(model.get("MJCF_PATH"))).name,
        "KEYPOINT_MODEL_PAIRS": pairs,
        "KEYPOINT_INITIAL_OFFSETS": [parse_pos(offsets[k]) if k in offsets else None for k, _ in pairs],
        "SCALE_FACTOR": float(model.get("SCALE_FACTOR", 1.0)),
        "MARKER_SIZE": float(model.get("MARKER_SIZE", 0.005)),
    }


def model_key_differences(recorded: Mapping, model: Mapping) -> list[str]:
    """The COMPILED_KEYS on which two model configs differ."""
    a, b = _compiled_view(recorded), _compiled_view(model)
    return [k for k in COMPILED_KEYS if a[k] != b[k]]


def bundle_for_config(cfg, base_path: str | Path | None = None) -> dict[str, np.ndarray]:
    """The model of a composed config, as bundle arrays.

    A checked-in bundle whose recorded model config equals ``cfg.model`` on
    COMPILED_KEYS serves it; the ``Stac`` derives the rest from the config.
    Otherwise the model is compiled from its MJCF (base_path / MJCF_PATH,
    then ``utils.assets.resolve_asset``) by ``models/builder.bundle_arrays``,
    which needs mujoco. Raises ValueError, naming what is missing and how to
    export a bundle, when the MJCF is not found or mujoco does not import."""
    from stac_mjx_tpu_torch.models import builder

    model = cfg.model.to_dict()
    seen = []
    for path in sorted(ASSETS.glob("*_bundle.npz")):
        bundle = load_bundle(path)
        diffs = model_key_differences(json.loads(str(bundle["model_config"])), model)
        if not diffs:
            return bundle
        seen.append(f"{path.name} differs in {', '.join(diffs)}")
    why = "no checked-in model bundle matches this model config (" + "; ".join(seen) + ")"
    export = (
        "; compile a bundle on a host that has the MJCF and mujoco, and put it in stac_mjx_tpu_torch/assets/: "
        "np.savez(bridge.bundle_path(<name>), **models.builder.bundle_arrays(cfg)), or, where jax imports too, "
        "python scripts/export_torch_bundle.py --model <configs/model name> --stac <configs/stac name>"
    )
    xml = builder.resolve_mjcf(model, base_path)
    if not xml.exists():
        raise ValueError(f"{why}, and its MJCF {model['MJCF_PATH']!r} was not found (tried {xml}){export}")
    try:
        builder.import_mujoco()
    except ImportError as e:
        raise ValueError(f"{why}, and compiling it from {xml} needs mujoco, which does not import here ({e}){export}") from e
    return builder.bundle_arrays(cfg, base_path)
