"""Stac orchestrator (port of ``stac_mjx_tpu/stac.py``: fit and ik in every
pose mode, q_solver, fk_impl and part schedule of the JAX package).

Built from a model bundle (``bridge.load_bundle()``) plus a stac config with
the keys of ``configs/stac/*.yaml`` given as a mapping; model scalars
(N_ITERS, N_SAMPLE_FRAMES, ...) come from the bundle and may be overridden.
Writing h5 files and loading YAML configs stay with the JAX package for now.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from stac_mjx_tpu_torch import pipeline
from stac_mjx_tpu_torch.bridge import MODEL_SCALARS, fit_model_from_arrays, resolve_device
from stac_mjx_tpu_torch.models.kinematics import JNT_FREE, JNT_SLIDE
from stac_mjx_tpu_torch.ops.stac_core import StacCore
from stac_mjx_tpu_torch.utils.batching import batch_kp_data


@dataclasses.dataclass
class StacData:
    """Output container; the fields of the JAX package's ``io.StacData``."""

    qpos: np.ndarray
    xpos: np.ndarray
    xquat: np.ndarray
    marker_sites: np.ndarray
    offsets: np.ndarray
    kp_data: np.ndarray
    names_qpos: list
    names_xpos: list
    kp_names: list
    qvel: np.ndarray = dataclasses.field(default_factory=lambda: np.array([]))


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class Stac:
    """Skeletal registration orchestrator on one device (fit_offsets / ik_only)."""

    def __init__(
        self,
        bundle: Mapping[str, np.ndarray],
        stac: Mapping,
        model: Mapping | None = None,
        device: torch.device | str = "cuda",
        dtype: torch.dtype = torch.float32,
    ):
        """bundle: arrays from ``bridge.load_bundle``; stac: stac config keys
        (a mapping or a dataclass); model: overrides of the bundle's MODEL_SCALARS.
        Runs on the card unless ``device`` says otherwise; raises if there is none."""
        self.stac_cfg = dataclasses.asdict(stac) if dataclasses.is_dataclass(stac) else dict(stac)
        self.model_cfg = {k: np.asarray(bundle[k]).item() for k in MODEL_SCALARS}
        self.model_cfg.update(model or {})
        self.device = resolve_device(device)
        self.dtype = dtype
        get = self.stac_cfg.get

        fm = fit_model_from_arrays(bundle, self.device, dtype)
        self.topo = fm.topo
        self.params = fm.params
        self._body_site_idxs = fm.site_idxs
        self._is_regularized = torch.as_tensor(fm.is_regularized, device=self.device).to(dtype)
        self._body_names = fm.topo.body_names
        self._kp_names = [str(s) for s in bundle["kp_names"]]
        self._part_names = [str(s) for s in bundle["part_names"]]
        self._root_kp_idx = int(bundle["root_kp_idx"])
        self._lb = torch.as_tensor(bundle["lb"], device=self.device).to(dtype)
        self._ub = torch.as_tensor(bundle["ub"], device=self.device).to(dtype)
        self._indiv_parts = [np.asarray(m, bool) for m in bundle["indiv_parts"]]
        self._trunk_kps = np.asarray(bundle["trunk_kps"], bool)

        root_type = int(self.topo.jnt_type[0]) if self.topo.njnt else -1
        self._freejoint = root_type == JNT_FREE
        self._slidejoint = root_type == JNT_SLIDE
        self._fixed = not (self._freejoint or self._slidejoint)

        if (get("wire_dtype", "float32") or "float32") != "float32":
            raise NotImplementedError("stac.wire_dtype=float16 is not ported (float32 only)")
        self.stac_core_obj = StacCore(
            self.topo,
            self._body_site_idxs,
            self.device,
            tol=float(self.model_cfg["FTOL"]),
            n_iter_q=int(self.model_cfg["N_ITER_Q"]),
            q_solver=get("q_solver", "pg") or "pg",
            fk_impl=get("fk_impl", "scan") or "scan",
            gn_stall_iters=int(get("gn_stall_iters", 0)),
            gn_damping_rule=get("gn_damping_rule", "nielsen") or "nielsen",
            gn_iters=int(get("gn_iters", 0)),
        )
        self._offsets = _numpy(self.params.site_pos[self.stac_core_obj.site_idxs_t])

        pose_mode = get("pose_mode", "sequential") or "sequential"
        skip_parts = bool(get("skip_part_opt", False))
        root_passes = int(get("root_opt_passes", 0) or 0)
        if root_passes <= 0:
            root_passes = 1 if pose_mode == "lockstep" else 2
        # Part schedule: "auto" batches the parts in one sweep only where the
        # natively batched solver runs (lockstep gn-lm); else the chain.
        part_mode = get("part_opt_mode", "auto") or "auto"
        if part_mode == "auto":
            lockstep_lm = pose_mode == "lockstep" and get("q_solver", "pg") == "gn-lm"
            part_mode = "batched" if lockstep_lm else "sequential"
        if self._indiv_parts and not skip_parts:
            print(f"part optimization: {len(self._indiv_parts)} parts, '{part_mode}' schedule")
        self._static_cfg = pipeline.StacConfigStatic(
            n_iters=int(self.model_cfg["N_ITERS"]),
            n_sample_frames=int(self.model_cfg["N_SAMPLE_FRAMES"]),
            m_reg_coef=float(self.model_cfg["M_REG_COEF"]),
            root_kp_idx=self._root_kp_idx,
            root_dims=4 if self._slidejoint else 7,
            do_root_opt=(self._root_kp_idx >= 0) and not self._fixed,
            indiv_parts=() if skip_parts else tuple(self._indiv_parts),
            trunk_kps=self._trunk_kps,
            pose_mode=pose_mode,
            root_opt_passes=root_passes,
            part_opt_mode=part_mode,
            hier_stride=int(get("ik_hier_stride", 0) or 0),
            hier_fine_iters=int(get("ik_hier_fine_iters", 0) or 0),
            fit_warm_iters=int(get("fit_warm_iters", 0) or 0),
        )

    def _to_device(self, kp) -> torch.Tensor:
        """Keypoints travel as float32 (the JAX package's f32 wire), then take the compute dtype."""
        if isinstance(kp, torch.Tensor):
            kp = kp.to(self.device, torch.float32)
        else:
            kp = torch.as_tensor(np.array(kp, np.float32), device=self.device)
        return kp.to(self.dtype)

    @staticmethod
    def _error_stats(errors) -> tuple[float, float]:
        flat = np.asarray(errors).reshape(-1)
        return float(np.mean(flat)), float(np.std(flat))

    # --------------------------------------------------------------- fit

    def fit_offsets(self, kp_data, return_full=None) -> StacData:
        """Alternating pose/offset calibration on kp_data (F, 3K)."""
        if return_full is None:
            return_full = bool(self.stac_cfg.get("fit_return_full", True))
        kp = self._to_device(kp_data)
        out = pipeline.fit_offsets_program(
            self.stac_core_obj,
            self._static_cfg,
            self.params,
            kp,
            self._lb,
            self._ub,
            self._is_regularized,
            return_full=return_full,
        )
        out = {k: _numpy(v) for k, v in out.items()}
        for i in range(self._static_cfg.n_iters):
            mean, std = self._error_stats(out["iter_frame_errors"][i])
            print(
                f"Calibration iteration {i + 1}/{self._static_cfg.n_iters}: "
                f"mean marker error {mean:.6g} m (std {std:.6g}); "
                f"m-phase residual {out['iter_m_errors'][i]:.6g}"
            )
        mean, std = self._error_stats(out["frame_error"])
        print(f"Final pose optimization: mean marker error {mean:.6g} m (std {std:.6g})")
        self._offsets = out["offsets"]
        return self._package_data(
            out["qpos"],
            out.get("xpos"),
            out.get("xquat"),
            out.get("marker_sites"),
            _numpy(kp),
        )

    # ---------------------------------------------------------------- ik

    def ik_only(self, kp_data, offsets, return_full=None) -> StacData:
        """Batched IK with frozen offsets over clips of stac.n_frames_per_clip."""
        if return_full is None:
            return_full = bool(self.stac_cfg.get("ik_return_full", True))
        kp = self._to_device(kp_data)
        batched_kp = batch_kp_data(
            kp,
            int(self.stac_cfg["n_frames_per_clip"]),
            continuous=bool(self.stac_cfg.get("continuous", False)),
        )
        offsets = torch.as_tensor(np.array(offsets), device=self.device).to(self.dtype)
        out = pipeline.ik_only_program(
            self.stac_core_obj,
            self._static_cfg,
            self.params,
            batched_kp,
            offsets,
            self._lb,
            self._ub,
            return_full=return_full,
        )
        out = [_numpy(a) for a in out]
        if return_full:
            qposes, xposes, xquats, marker_sites, errors = out
        else:
            (qposes, errors), xposes, xquats, marker_sites = out, None, None, None
        mean, std = self._error_stats(errors)
        print(f"ik_only: mean marker error {mean:.6g} m (std {std:.6g})")
        self._offsets = _numpy(offsets)
        return self._package_data(
            qposes, xposes, xquats, marker_sites, _numpy(batched_kp), batched=True
        )

    # ----------------------------------------------------------- package

    def compute_full_outputs(self, qposes):
        """xpos, xquat, marker_sites (numpy) for qposes (F, nq) at the current offsets."""
        core = self.stac_core_obj
        params = self.params.set_site_pos(
            torch.as_tensor(self._offsets, device=self.device).to(self.dtype),
            core.site_idxs_t,
        )
        q = torch.as_tensor(np.asarray(qposes), device=self.device).to(self.dtype)
        res = core.fk(params, q)
        return _numpy(res.xpos), _numpy(res.xquat), _numpy(res.site_xpos[:, core.site_idxs_t])

    def _package_data(
        self, qposes, xposes, xquats, marker_sites, kp_data, batched=False
    ) -> StacData:
        """Results as StacData, with the JAX package's reshapes, including its
        order='F' flattening of batched xpos/xquat. xposes/xquats/
        marker_sites may be None (lean payload) and package as empty arrays."""
        lean = xposes is None
        if lean:
            xposes = np.zeros((0,), np.float32)
            xquats = np.zeros((0,), np.float32)
            marker_sites = np.zeros((0,), np.float32)
        if batched:
            qposes = qposes.reshape(-1, qposes.shape[-1])
            if not lean:
                xposes = xposes.reshape(-1, *xposes.shape[2:], order="F")
                xquats = xquats.reshape(-1, *xquats.shape[2:], order="F")
                marker_sites = marker_sites.reshape(-1, *marker_sites.shape[2:])
        return StacData(
            qpos=qposes,
            xpos=xposes,
            xquat=xquats,
            marker_sites=marker_sites,
            offsets=np.array(self._offsets),
            kp_data=kp_data.reshape(-1, kp_data.shape[-1]),
            names_qpos=self._part_names,
            names_xpos=self._body_names,
            kp_names=self._kp_names,
        )
