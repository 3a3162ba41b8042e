"""Shared set-up for the PyTorch port's tests: the same first-party
configuration built in both packages, and conversions between them."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from stac_mjx_tpu.config import compose_config
from stac_mjx_tpu.models import firstparty
from stac_mjx_tpu.stac import Stac as JaxStac
from stac_mjx_tpu_torch import bridge
from stac_mjx_tpu_torch.stac import Stac as TorchStac

REPO = Path(__file__).resolve().parent.parent

# The throughput configuration of the slice (bench.py's), at test sizes.
THROUGHPUT = {
    "pose_mode": "lockstep",
    "q_solver": "gn-lm",
    "skip_part_opt": True,
    "fk_impl": "jump",
    "continuous": False,
}


def _fmt(v) -> str:
    return str(v).lower() if isinstance(v, bool) else str(v)


def jax_stac(stac: dict, model: dict | None = None) -> JaxStac:
    """The JAX package's Stac on firstparty with the given stac/model keys."""
    overrides = ["model=firstparty", "stac=firstparty"]
    overrides += [f"stac.{k}={_fmt(v)}" for k, v in stac.items()]
    overrides += [f"model.{k}={_fmt(v)}" for k, v in (model or {}).items()]
    cfg = compose_config(REPO / "configs", overrides=overrides)
    return JaxStac(REPO / "models" / "firstparty.xml", cfg, list(firstparty.KEYPOINTS))


def torch_stac(stac: dict, model: dict | None = None, dtype=torch.float32) -> TorchStac:
    """The port's Stac on the checked-in bundle, on the CPU."""
    return TorchStac(bridge.load_bundle(), stac, model, device="cpu", dtype=dtype)


def np64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)
