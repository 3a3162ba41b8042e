"""PyTorch / CUDA port of stac_mjx_tpu for NVIDIA Hopper GPUs.

Mirrors the JAX package's module layout (``models/kinematics.py``,
``ops/gn_ik.py``, ``pipeline.py``, ``stac.py`` ...) so each port sits next
to its reference by name. It imports torch and numpy only: no jax, mujoco,
yaml or h5py. The fitting model comes from a bundle exported on the host
(``assets/firstparty_bundle.npz``, see ``bridge.py``).

Float32 matrix products run in full float32: TF32 would keep ~3 decimal
digits in the Gauss-Newton normal equations (JᵀJ, Jᵀe), which the JAX
reference forms in full f32. Both switches are set here, once, on import.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
