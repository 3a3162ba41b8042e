"""PyTorch / CUDA port of stac_mjx_tpu for NVIDIA Hopper GPUs.

Mirrors the JAX package's module layout (``models/kinematics.py``,
``ops/gn_ik.py``, ``pipeline.py``, ``stac.py``, ``main.py`` ...) so each port
sits next to its reference by name. Public API, as the JAX package's minus
``enable_xla_flags``: ``load_data``, ``load_configs``, ``run_stac``,
``viz_stac`` and ``__version__``; ``cli.py`` is the console entry point.

The solve path imports torch and numpy only. The driver's I/O imports h5py
(artifacts, NWB and .h5 recordings), scipy (.mat recordings) and PyYAML
(configs) in the functions that use them; the model builder and the
renderer import mujoco there too. A fitting model comes from a checked-in
bundle (``assets/*_bundle.npz``) where one serves the config, else from its
MJCF compiled by the port's builder (``bridge.bundle_for_config``).

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
from stac_mjx_tpu_torch.version import __version__  # noqa: E402


def viz_stac(*args, **kwargs):
    """Render the fitted qpos of a STAC output file (``viz.viz_stac``; imported
    on first use, since it needs mujoco and OpenGL)."""
    from stac_mjx_tpu_torch.viz import viz_stac as _viz

    return _viz(*args, **kwargs)


__all__ = ["load_data", "load_configs", "run_stac", "viz_stac", "__version__"]
