"""What decides ``correct``: the program's outputs, judged by the plain
reference after the window has closed.

Each cell compares a few numbers, each against its limit in
``portbench/limits/<workload>.json`` (a number passes when it is at most
its limit). The readings each limit was set from are in PERF.md. The
numbers:

- ``resid_p25_mm``: the first quartile over the frames of a frame's mean
  marker residual, the markers recomputed by the reference FK (float64)
  from the program's poses (and offsets) against the keypoints it was
  handed: the frames that converge fully sit at float32's floor, which a
  lower precision cannot reach;
- ``worst_frame_mm``: the largest such frame residual (an answer altered
  where it is produced);
- ``fk_gap_um``: where the entry returns the marker positions its own FK
  computed, the largest |those - the reference FK's from the same poses
  and offsets| (the FK layer, judged directly);
- ``box_excess``: the most that any pose coordinate leaves the joint box
  the configuration states, each bound rounded to float32 as the program's
  clip sees it, a unit quaternion's [-1, 1] widened by the rounding of a
  float32 normalisation, 2^-22 (exact: limit 0);
- ``bad_frames``: frames that came back missing or not finite (exact: 0);
- ``mphase_gap_mm`` (fit): the mean |fitted offsets - the reference's
  closed-form offsets on the program's final poses| of the worst fit: the
  m-phase, judged on the program's own poses.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.fk import FK, marker_residuals
from portbench.reference.mphase import closed_form_offsets


class Tally:
    """Per-frame readings gathered over the window's outputs."""

    def __init__(self, model):
        lb, ub = model.box()
        quat = model.quaternion_mask()
        self.lb32 = np.where(quat, lb - 2.0**-22, lb).astype(np.float32)
        self.ub32 = np.where(quat, ub + 2.0**-22, ub).astype(np.float32)
        self.frame_resid = []  # per call: (F,) mean residual of each frame, m
        self.marker_sum, self.marker_n = 0.0, 0
        self.box_excess, self.bad_frames, self.fk_gap = 0.0, 0, None
        self.per_call = []  # each output's own numbers

    def add_poses(self, fk: FK, qpos: np.ndarray, offsets, kp, n_expected: int, markers=None) -> None:
        """One output's poses (F, nq) at offsets (K, 3) against keypoints (F, 3K),
        with the marker positions (F, K, 3) the program returned, if any."""
        qpos = np.asarray(qpos)
        bad, excess, fr, gap = 0, 0.0, np.zeros(0), None
        if markers is not None and len(markers) == 0:
            markers = None
        if qpos.ndim != 2 or qpos.shape[0] != n_expected:
            bad += abs(n_expected - (qpos.shape[0] if qpos.ndim == 2 else 0))
            n = min(n_expected, qpos.shape[0]) if qpos.ndim == 2 else 0
            qpos, kp = qpos[:n].reshape(n, -1), kp[:n]
            markers = None if markers is None else markers[:n]
        finite = np.isfinite(qpos).all(axis=1)
        bad += int((~finite).sum())
        qpos, kp = qpos[finite], kp[finite]
        markers = None if markers is None else np.asarray(markers)[finite]
        if len(qpos):
            over = np.maximum(np.maximum(self.lb32 - qpos, qpos - self.ub32), 0.0)
            excess = float(over.max())
            r = marker_residuals(fk, qpos, offsets, kp, markers)
            if markers is not None:
                r, gap = r
                self.fk_gap = max(self.fk_gap or 0.0, gap)
            fr = r.mean(dim=1).cpu().numpy()
            self.frame_resid.append(fr)
            self.marker_sum += float(r.sum())
            self.marker_n += r.numel()
        self.box_excess = max(self.box_excess, excess)
        self.bad_frames += bad
        self.per_call.append(self._numbers(fr, excess, bad, gap))

    @staticmethod
    def _numbers(fr: np.ndarray, excess: float, bad: int, gap) -> dict:
        out = {
            "resid_p25_mm": float(np.percentile(fr, 25)) * 1e3 if fr.size else float("inf"),
            "worst_frame_mm": float(fr.max()) * 1e3 if fr.size else float("inf"),
            "box_excess": excess,
            "bad_frames": float(bad),
        }
        if gap is not None:
            out["fk_gap_um"] = gap * 1e6
        return out

    def numbers(self) -> dict:
        fr = np.concatenate(self.frame_resid) if self.frame_resid else np.zeros(0)
        return self._numbers(fr, self.box_excess, self.bad_frames, self.fk_gap)

    def residual_mm(self) -> float:
        """The mean marker residual over every frame and marker, mm."""
        return 1e3 * self.marker_sum / self.marker_n if self.marker_n else float("inf")


class FitTally:
    """Offset readings of the window's fits."""

    def __init__(self, model):
        self.model = model
        self.err, self.gap = [], []

    def add(self, fk: FK, fitted, true, qpos, kp, coef: float) -> None:
        fitted = np.asarray(fitted, np.float64)
        self.err.append(float(np.abs(fitted - true).mean()))
        m = self.model
        ref = closed_form_offsets(fk, qpos, kp, m.initial_offsets(), m.regularized(), coef)
        self.gap.append(float(np.abs(fitted - ref).mean()))

    def per_call(self) -> list[dict]:
        return [{"mphase_gap_mm": 1e3 * g} for g in self.gap]

    def numbers(self) -> dict:
        return {"mphase_gap_mm": 1e3 * float(np.max(self.gap)) if self.gap else float("inf")}

    def offset_err_mm(self) -> float:
        return 1e3 * float(np.mean(self.err)) if self.err else float("inf")


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number at most its limit, {name: {"value", "limit"}}) over
    the numbers that have a limit; a number without a reading fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name, float("inf"))
        out[name] = {"value": v, "limit": limit}
        ok &= bool(np.isfinite(v) and v <= limit)
    return ok, out
