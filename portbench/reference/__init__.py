"""Plain reference of the benchmark: forward kinematics, joint boxes and the
closed-form offset solve, in plain PyTorch from a model bundle's raw arrays.

Imports nothing of the program under test (``stac_mjx_tpu_torch``), of the
JAX package or of JAX.
"""
