"""Asset path resolution (port of ``stac_mjx_tpu/utils/assets.py``).

Relative data and model paths are looked up, in order, under the caller's
base path, each directory of ``$STAC_TPU_ASSET_PATH`` (colon-separated), and
the repository's root. The JAX package also falls back to a read-only
reference checkout at a fixed location; here such a checkout is named through
``$STAC_TPU_ASSET_PATH`` instead.
"""

from __future__ import annotations

import os
from pathlib import Path

_REPO_ROOT = Path(__file__).resolve().parents[2]


def asset_roots() -> list[Path]:
    """Candidate roots for resolving relative asset paths."""
    roots = []
    env = os.environ.get("STAC_TPU_ASSET_PATH")
    if env:
        roots.extend(Path(p) for p in env.split(":"))
    roots.append(_REPO_ROOT)
    return roots


def resolve_asset(rel_path: str | Path, base_path: Path | None = None) -> Path:
    """Resolve a relative asset path against the known roots.

    An absolute path is returned unchanged; ``base_path`` is tried first. When
    nothing exists, the first candidate is returned (the caller's open fails
    with that path).
    """
    p = Path(rel_path)
    if p.is_absolute():
        return p
    candidates = []
    if base_path is not None:
        candidates.append(Path(base_path) / p)
    candidates.extend(root / p for root in asset_roots())
    for c in candidates:
        if c.exists():
            return c
    return candidates[0] if candidates else p
