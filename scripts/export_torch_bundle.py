"""Export a fitting model as the PyTorch port's bundle.

The port runs where jax and mujoco may be missing, so the model the JAX
package compiles (MJCF + keypoint sites + rescale, then ``extract_model`` and
``_align_joint_dims``) is frozen here, on a host that has both, into
``stac_mjx_tpu_torch/assets/<model>_bundle.npz``: a few KB of numpy arrays,
with no pickled objects, and the composed model config as a JSON string
(``bridge.bundle_for_config`` matches configs against it).
``tests/test_torch_bridge.py`` checks that the checked-in files still equal
a fresh export.

    python scripts/export_torch_bundle.py                 # firstparty
    python scripts/export_torch_bundle.py --model synth_data --stac stac_synth_data
    python scripts/export_torch_bundle.py --out OUT.npz   # another path
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent


def bundle_arrays(
    repo_root: str | Path = REPO, model: str = "firstparty", stac: str = "firstparty"
) -> dict[str, np.ndarray]:
    """Every array the port needs, taken from the JAX package's own ``Stac``."""
    from stac_mjx_tpu.config import compose_config
    from stac_mjx_tpu.stac import Stac, _align_joint_dims
    from stac_mjx_tpu_torch.bridge import KINPARAMS_FIELDS, MODEL_SCALARS, TOPOLOGY_FIELDS

    root = Path(repo_root)
    cfg = compose_config(root / "configs", overrides=[f"model={model}", f"stac={stac}"])
    kp_names = list(cfg.model.KEYPOINT_MODEL_PAIRS.keys())
    stac = Stac(root / cfg.model.MJCF_PATH, cfg, kp_names)
    fm, topo = stac._fit_model, stac.topo
    m = fm.mj_model

    out: dict[str, np.ndarray] = {}
    for k in TOPOLOGY_FIELDS:
        v = getattr(topo, k)
        out[k] = np.array(v, dtype=str) if isinstance(v, list) else np.asarray(v)
    # KinParams in the model's own float64 (the JAX Stac rounds them to f32).
    for k in KINPARAMS_FIELDS:
        out[k] = np.asarray(getattr(m, k), np.float64)
    lb, ub, part_names = _align_joint_dims(topo.jnt_type, np.asarray(m.jnt_range), topo.jnt_names)
    out.update(
        site_idxs=np.asarray(fm.site_idxs, np.int32),
        is_regularized=np.asarray(fm.is_regularized, np.float64),
        lb=lb,
        ub=ub,
        part_names=np.array(part_names, dtype=str),
        jnt_range=np.asarray(m.jnt_range, np.float64),
        indiv_parts=np.array(stac._indiv_parts, dtype=bool).reshape(-1, topo.nq),
        trunk_kps=np.asarray(stac._trunk_kps, bool),
        root_kp_idx=np.asarray(stac._root_kp_idx),
        kp_names=np.array(kp_names, dtype=str),
        timestep=np.asarray(fm.timestep, np.float64),
    )
    for k in MODEL_SCALARS:
        out[k] = np.asarray(getattr(cfg.model, k))
    # The composed model config, by which the port finds this bundle.
    out["model_config"] = np.array(json.dumps(cfg.model.to_dict()))
    return out


def main(argv: list[str]) -> None:
    from stac_mjx_tpu_torch.bridge import bundle_path

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="firstparty", help="configs/model/<name>.yaml")
    ap.add_argument("--stac", default="firstparty", help="configs/stac/<name>.yaml")
    ap.add_argument("--out", type=Path, help="default: stac_mjx_tpu_torch/assets/<model>_bundle.npz")
    args = ap.parse_args(argv)
    path = args.out or bundle_path(args.model)
    np.savez_compressed(path, **bundle_arrays(model=args.model, stac=args.stac))
    print(f"wrote {path} ({path.stat().st_size} bytes)")


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    main(sys.argv[1:])
