"""Utility namespace (port of ``stac_mjx_tpu/utils/__init__.py``).

Re-exports the JAX package's helpers minus its three XLA ones
(``enable_xla_flags``, ``force_cpu``, ``host_device_count``: the port has no
XLA flags); implementations live in the focused submodules. Imports torch
and numpy only.
"""

from stac_mjx_tpu_torch.utils.batching import (
    CONTINUOUS_BATCH_OVERLAP,
    batch_kp_data,
    handle_edge_effects,
)
from stac_mjx_tpu_torch.utils.velocity import compute_velocity_from_kinematics

__all__ = [
    "CONTINUOUS_BATCH_OVERLAP",
    "batch_kp_data",
    "handle_edge_effects",
    "compute_velocity_from_kinematics",
]
