"""Shared set-up for the PyTorch port's tests: the same first-party
configuration built in both packages, and conversions between them."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from stac_mjx_tpu.config import compose_config
from stac_mjx_tpu.models import firstparty
from stac_mjx_tpu.stac import Stac as JaxStac
from stac_mjx_tpu_torch import bridge
from stac_mjx_tpu_torch.stac import Stac as TorchStac

REPO = Path(__file__).resolve().parent.parent

# The tests' tensors are tiny: intra-op threads only add synchronisation
# (a 64-frame FK measured 50x slower with 8 threads than with 1, with several
# test workers sharing the cores).
torch.set_num_threads(1)

# The throughput configuration of the slice (bench.py's), at test sizes.
THROUGHPUT = {
    "pose_mode": "lockstep",
    "q_solver": "gn-lm",
    "skip_part_opt": True,
    "fk_impl": "jump",
    "continuous": False,
}


def _fmt(v) -> str:
    return str(v).lower() if isinstance(v, bool) else str(v)


def jax_stac(stac: dict, model: dict | None = None) -> JaxStac:
    """The JAX package's Stac on firstparty with the given stac/model keys."""
    overrides = ["model=firstparty", "stac=firstparty"]
    overrides += [f"stac.{k}={_fmt(v)}" for k, v in stac.items()]
    overrides += [f"model.{k}={_fmt(v)}" for k, v in (model or {}).items()]
    cfg = compose_config(REPO / "configs", overrides=overrides)
    return JaxStac(REPO / "models" / "firstparty.xml", cfg, list(firstparty.KEYPOINTS))


def torch_stac(stac: dict, model: dict | None = None, dtype=torch.float32) -> TorchStac:
    """The port's Stac on the checked-in bundle, on the CPU."""
    return TorchStac(bridge.load_bundle(), stac, model, device="cpu", dtype=dtype)


def assert_same_static_cfg(port_cfg, jax_cfg) -> None:
    """The two packages resolved the same pipeline configuration."""
    import dataclasses

    for f in dataclasses.fields(port_cfg):
        a, b = getattr(port_cfg, f.name), getattr(jax_cfg, f.name)
        if f.name == "indiv_parts":
            assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b)), f.name
        else:
            np.testing.assert_array_equal(a, b, err_msg=f.name)


class JaxSequential:
    """The JAX package's sequential fit and ik on float64 parameters, each
    pass jitted once and reused.

    ``fit_offsets_program`` jitted whole compiles every pose pass of the
    alternation anew, and ``ik_only_program`` its per-clip chain again, each
    with (1 + parts) solver loops: minutes of XLA compile on a CPU. Here the
    same JAX functions run in the same order (root solve, n_iters x (pose
    pass, m-phase), final pose pass; per clip: root solve, pose pass), each
    jitted once, so a fit and an ik on clips as long as the fit share two
    compiles. ``jax.vmap`` over clips is replaced by a loop over them: the
    clips are independent lanes.
    """

    def __init__(self, js: JaxStac, params, lb, ub, is_regularized):
        import jax

        from stac_mjx_tpu import pipeline as jpipe

        core, cfg = js.stac_core_obj, js._static_cfg
        self.cfg, self.params, self.site_idxs = cfg, params, np.asarray(core.site_idxs)
        self.is_regularized = is_regularized
        self.root = jax.jit(lambda p, kp0, q0: jpipe.root_optimization(core, cfg, p, kp0, q0, lb, ub))

        def pose(p, kp, q0):  # (q_last, qposes, errors)
            out = jpipe.pose_optimization(core, cfg, p, kp, q0, lb, ub)
            return out[0], out[1], out[5]

        self.pose = jax.jit(pose)
        self.m_phase = jax.jit(
            lambda p, kp, off, qposes: jpipe.offset_optimization(core, cfg, p, kp, off, qposes, is_regularized)
        )

    def _root(self, params, kp0, q0):
        cfg = self.cfg
        return self.root(params, kp0, q0) if cfg.do_root_opt and cfg.root_kp_idx >= 0 else q0

    def fit(self, kp) -> dict:
        """fit_offsets_program's sequential schedule: qpos, offsets and errors."""
        params = self.params
        offsets = params.site_pos[self.site_idxs]
        q = self._root(params, kp[0], params.qpos0)
        iter_errors, iter_m = [], []
        for _ in range(self.cfg.n_iters):
            q, qposes, errors = self.pose(params, kp, q)
            params, offsets, m_err = self.m_phase(params, kp, offsets, qposes)
            iter_errors.append(errors)
            iter_m.append(m_err)
        _, qposes, errors = self.pose(params, kp, q)
        return dict(qpos=np.asarray(qposes), offsets=np.asarray(offsets), frame_error=np.asarray(errors),
                    iter_frame_errors=np.stack(iter_errors), iter_m_errors=np.stack(iter_m))

    def ik(self, batched_kp, offsets):
        """ik_only_program's sequential per-clip branch: (qpos, errors), (C, Fc, ·)."""
        params = self.params.set_site_pos(offsets, self.site_idxs)
        out = [self.pose(params, kp, self._root(params, kp[0], params.qpos0))[1:] for kp in batched_kp]
        return tuple(np.stack([np.asarray(o[i]) for o in out]) for i in range(2))


def np64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)
