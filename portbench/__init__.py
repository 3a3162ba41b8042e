"""The benchmark of the PyTorch/CUDA port ``stac_mjx_tpu_torch`` (see README.md)."""
