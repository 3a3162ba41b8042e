"""dist_job: one rank of a job over several cards, one process per card:
``Stac.fit_offsets_sharded`` on this rank's block of the calibration
frames (the m-phase's statistics all-reduced), then ``Stac.ik_only_global``
on this rank's block of the session's clips at the fitted offsets (the
outputs all-gathered in rank order); the session is of the animal the fit
calibrated. Every rank makes the same inputs from
the seed and keeps its block; rank 0 keeps the gathered outputs for the
check.

Traffic keys: ``fit_clips`` (stretches of ``clip_frames`` frames to
calibrate on), ``clips``, ``clip_frames``, ``animals`` (a calibration
recording and a session of each, made in set-up; the calls cycle over
them in an order drawn from the seed), ``noise_m``; both divide evenly
over the ranks. The calibration recordings are fixed, not drawn from the
seed, as in ``jobs/fit.py``: the fitted offsets, and with them the
session's residual, swing with the calibration's motion. The sessions
are drawn from the seed, as in ``jobs/ik.py``.
"""

from __future__ import annotations

import time

import numpy as np

from portbench.harness.check import FitTally, Tally
from portbench.harness.gen import animal_offsets, make_recording, substream
from portbench.harness.job import Job as Base
from portbench.harness.job import quiet


def _prefixed(d: dict, prefix: str) -> dict:
    return {prefix + k: v for k, v in d.items()}


class Job(Base):
    fits_per_call = 1

    def __init__(self, cell, seed, device, control=False, mesh=None):
        super().__init__(cell, seed, device, control)
        tr = self.traffic
        self.mesh = mesh
        ranks, rank = (mesh.size, mesh.rank) if mesh is not None else (1, 0)
        self.rank = rank
        C, T = int(tr["clips"]), int(tr["clip_frames"])
        F = int(tr["fit_clips"]) * T
        if F % ranks or C % ranks:
            raise ValueError(f"{F} fit frames and {C} clips must divide over {ranks} ranks")
        f_lo, c_lo = rank * F // ranks, rank * C // ranks
        noise = float(tr.get("noise_m", 0.0))
        self.fit_kp, self.fit_true, self.ik_kp, self.kp_all, self.local = [], [], [], [], []
        animals = int(tr["animals"])
        for i in range(animals):
            animal = animal_offsets(self.model, i)
            fit = make_recording(self.fk, F // T, T, substream(0, 3, i), noise, offsets=animal)
            ses = make_recording(self.fk, C, T, substream(seed, 4, i), noise, offsets=animal)
            fit_kp, ses_kp = self.to_host(fit["kp"]), self.to_host(ses["kp"])
            self.local.append((fit_kp[f_lo : f_lo + F // ranks],
                               ses_kp.reshape(C, T, -1)[c_lo : c_lo + C // ranks].copy()))
            if rank == 0:
                self.fit_kp.append(fit_kp)
                self.fit_true.append(fit["offsets"])
                self.ik_kp.append(ses_kp)
            del fit, ses
        self.order = np.random.default_rng(substream(seed, 3)).permutation(animals)
        self.frames_per_call = C * T
        self.fit_frames = F
        self.start_window()

    def start_window(self) -> None:
        self.t_fit = self.t_ik = 0.0

    def call(self, i: int):
        r = int(self.order[i % len(self.order)])
        fit_kp, clips = self.local[r]
        with quiet():
            t0 = time.perf_counter()
            fit = self.stac.fit_offsets_sharded(fit_kp, self.mesh)
            t1 = time.perf_counter()
            ik = self.stac.ik_only_global(clips, fit.offsets, self.mesh)
            t2 = time.perf_counter()
        self.t_fit += t1 - t0
        self.t_ik += t2 - t1
        if self.rank != 0:
            return (r,)
        return r, fit.qpos, fit.offsets, fit.marker_sites, ik.qpos, ik.marker_sites

    def rates(self, calls: int, wall: float) -> dict:
        """Seconds per sharded fit and frames per second of the gathered ik,
        each over the time spent in its own calls."""
        return {"fit_s": self.t_fit / max(calls, 1), "ik_fps": calls * self.frames_per_call / self.t_ik}

    def evaluate(self, records) -> dict:
        ik, fitp, fits = Tally(self.model), Tally(self.model), FitTally(self.model)
        for r, fit_q, offsets, fit_m, ik_q, ik_m in records:
            fitp.add_poses(self.fk, fit_q, offsets, self.fit_kp[r], self.fit_frames, fit_m)
            fits.add(self.fk, offsets, self.fit_true[r], fit_q, self.fit_kp[r], self.m_reg_coef)
            ik.add_poses(self.fk, ik_q, offsets, self.ik_kp[r], self.frames_per_call, ik_m)
        per_call = [dict(a, **_prefixed(b, "fit_"), **c)
                    for a, b, c in zip(ik.per_call, fitp.per_call, fits.per_call())]
        return {"e2e": {"residual_mm": ik.residual_mm(), "offset_err_mm": fits.offset_err_mm()},
                "numbers": dict(ik.numbers(), **_prefixed(fitp.numbers(), "fit_"), **fits.numbers()),
                "per_call": per_call}
