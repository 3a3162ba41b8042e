"""PyTorch / CUDA port of stac_mjx_tpu for NVIDIA Hopper GPUs.

Mirrors the JAX package's module layout (``models/kinematics.py``,
``ops/gn_ik.py``, ``pipeline.py``, ``stac.py``, ``main.py`` ...) so each port
sits next to its reference by name. Public API, as the JAX package's minus
``enable_xla_flags`` and ``viz_stac``: ``load_data``, ``load_configs`` and
``run_stac``; ``cli.py`` is the console entry point.

The solve path imports torch and numpy only. The driver's I/O imports h5py
(artifacts, NWB and .h5 recordings), scipy (.mat recordings) and PyYAML
(configs) in the functions that use them. The fitting models come from
bundles exported on a host with the JAX package (``assets/*_bundle.npz``; see
``bridge.py``).

Float32 matrix products run in full float32: TF32 would keep ~3 decimal
digits in the Gauss-Newton normal equations (JᵀJ, Jᵀe), which the JAX
reference forms in full f32. Both switches are set here, once, on import.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from stac_mjx_tpu_torch.io import load_data  # noqa: E402
from stac_mjx_tpu_torch.main import load_configs, run_stac  # noqa: E402

__all__ = ["load_data", "load_configs", "run_stac"]
