"""Nothing the benchmark runs loads JAX or the JAX package, by whole
top-level module names."""

from __future__ import annotations

import subprocess
import sys

from portbench.harness.env import ROOT, forbidden_modules

LOAD_ALL = r"""
import importlib, pkgutil, sys
sys.path.insert(0, sys.argv[1])
import portbench, stac_mjx_tpu_torch
from portbench.harness import spec
for pkg in (portbench, stac_mjx_tpu_torch):
    for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        if ".tests" in mod.name or mod.name.endswith("__main__"):
            continue
        importlib.import_module(mod.name)
for m in spec.benchmark()["per_layer"]:
    spec.metric_reader(m["name"])
import portbench.run
from portbench.harness.env import forbidden_modules
print("FOUND", forbidden_modules())
"""


def test_whole_names_are_compared():
    assert forbidden_modules({"stac_mjx_tpu_torch": 1, "stac_mjx_tpu_torch.ops": 1, "jaxtyping": 1}) == []
    assert forbidden_modules({"stac_mjx_tpu.ops": 1, "jax.numpy": 1, "jaxlib": 1, "flax.linen": 1}) == [
        "flax.linen", "jax.numpy", "jaxlib", "stac_mjx_tpu.ops"]


def test_loading_the_benchmark_and_the_port_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", LOAD_ALL, str(ROOT)], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "FOUND []"
