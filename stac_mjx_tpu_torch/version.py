"""Package version (the JAX package's)."""

__version__ = "0.1.0"
