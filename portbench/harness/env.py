"""The run's surroundings: where caches go, which device it runs on, the
process's age, and the guard against JAX in the measuring process."""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]  # the checkout
CACHE = ROOT / ".portbench_cache"  # fixed, inside the checkout, git-ignored
FORBIDDEN = ("jax", "jaxlib", "flax", "stac_mjx_tpu")


def set_cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout, so that
    only a checkout's first run builds (the K1 library already lives in the
    program's own ``_build/`` inside the checkout). A library that loads
    JAX by itself is told not to."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def scratch_dir(prefix: str) -> Path:
    """A new directory of this run's own under TMPDIR or, without one, under
    the checkout's git-ignored cache: never a fixed path outside."""
    base = Path(os.environ["TMPDIR"]) if os.environ.get("TMPDIR") else CACHE / "tmp"
    base.mkdir(parents=True, exist_ok=True)
    return Path(tempfile.mkdtemp(prefix=prefix, dir=base))


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared as whole names: ``stac_mjx_tpu_torch`` is not
    ``stac_mjx_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})


def process_age_s() -> float:
    """Seconds since this process started (Linux /proc), or 0 elsewhere."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(0.0, uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def epoch_of_process_start() -> float:
    return time.time() - process_age_s()


def card(torch, chips: int) -> dict:
    """The device fields of the result line; raises SystemExit without
    enough cards."""
    if not torch.cuda.is_available():
        raise SystemExit("portbench: no CUDA device (torch.cuda.is_available() is false)")
    n = torch.cuda.device_count()
    if n < chips:
        raise SystemExit(f"portbench: the cell asks for {chips} cards, {n} present")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them, or ''."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else ""
    except (OSError, subprocess.SubprocessError):
        return ""
