"""One rank of the port's two-process CPU tests (gloo): imports torch, numpy
and the port only.

    python tests/_torch_dist_worker.py <port> <world> <rank> <inputs.npz> <outdir>

Runs, over the group, on this rank's half of each input: the all-reduced
``m_opt_closed_form``, ``psum_error_stats``, ``Stac.fit_offsets_sharded``
and ``Stac.ik_only_global`` (float64), and writes ``rank<r>.npz``.
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from stac_mjx_tpu_torch import bridge  # noqa: E402
from stac_mjx_tpu_torch.ops.solver import m_opt_closed_form  # noqa: E402
from stac_mjx_tpu_torch.parallel.distributed import (  # noqa: E402
    fetch_arrays,
    init_distributed,
    local_clip_range,
    make_global_clips,
    make_global_frames,
    pod_mesh,
    psum_error_stats,
)
from stac_mjx_tpu_torch.stac import Stac  # noqa: E402


def main(port: int, world: int, rank: int, inputs: str, outdir: str) -> None:
    torch.set_num_threads(1)
    init_distributed(backend="gloo", device="cpu", init_method=f"tcp://localhost:{port}",
                     world_size=world, rank=rank)
    mesh = pod_mesh("cpu")
    z = np.load(inputs)
    out = {}

    def block(a):
        lo, hi = local_clip_range(a.shape[0], mesh)
        return torch.as_tensor(a[lo:hi])

    m = m_opt_closed_form(block(z["p_all"]), block(z["R_all"]), block(z["y"]), torch.as_tensor(z["m0"]),
                          torch.as_tensor(z["isr"]), float(z["reg"]), group=mesh.group)
    out["m_params"], out["m_error"] = m.params.numpy(), m.error.numpy()
    mean, std = psum_error_stats(block(z["errors"]), mesh)
    out["stats"] = np.array([float(mean), float(std)])

    stac_cfg, model = json.loads(str(z["stac_cfg"])), json.loads(str(z["model"]))
    stac = Stac(bridge.load_bundle(), stac_cfg, model=model, device="cpu", dtype=torch.float64)
    lo, hi = local_clip_range(z["kp"].shape[0], mesh)
    fit = stac.fit_offsets_sharded(make_global_frames(z["kp"][lo:hi], mesh), mesh)
    for k in ("qpos", "offsets", "marker_sites", "xpos", "kp_data"):
        out[f"fit_{k}"] = getattr(fit, k)
    clips = z["kp"].reshape(int(z["n_clips"]), -1, z["kp"].shape[-1])
    lo, hi = local_clip_range(clips.shape[0], mesh)
    out["clip_range"] = np.array([lo, hi])
    ik = stac.ik_only_global(make_global_clips(clips[lo:hi], mesh), z["ik_offsets"], mesh)
    for k in ("qpos", "xpos", "xquat", "marker_sites", "kp_data", "offsets"):
        out[f"ik_{k}"] = getattr(ik, k)
    out["gathered_rows"] = fetch_arrays(torch.full((2, 3), float(rank)), mesh)
    np.savez(Path(outdir) / f"rank{rank}.npz", **out)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
