"""fit: calibrate one animal's marker offsets, one ``Stac.fit_offsets`` call
per job on a recording of its own.

Traffic keys: ``clips`` and ``clip_frames`` (the calibration frames:
that many stretches of motion), ``animals`` (one recording of each, at its
true offsets, made in set-up; the calls cycle over them in an order drawn
from the seed), ``noise_m``. The recordings themselves are fixed, not drawn
from the seed: a fit's residual swings with its recording's motion (over
six runs of 16 animals drawn per seed on an H100, the mean residual spread
16%), so every seed fits the same animals, in another order.
"""

from __future__ import annotations

import numpy as np

from portbench.harness.check import FitTally, Tally
from portbench.harness.gen import animal_offsets, make_recording, substream
from portbench.harness.job import Job as Base
from portbench.harness.job import quiet


class Job(Base):
    fits_per_call = 1

    def __init__(self, cell, seed, device, control=False):
        super().__init__(cell, seed, device, control)
        tr = self.traffic
        clips, clip_frames = int(tr["clips"]), int(tr["clip_frames"])
        self.kp, self.true = [], []
        animals = int(tr["animals"])
        for i in range(animals):
            rec = make_recording(self.fk, clips, clip_frames, substream(0, 2, i), float(tr.get("noise_m", 0.0)),
                                 offsets=animal_offsets(self.model, i))
            self.kp.append(self.to_host(rec["kp"]))
            self.true.append(rec["offsets"])
            del rec
        self.order = np.random.default_rng(substream(seed, 2)).permutation(animals)
        self.frames_per_call = clips * clip_frames

    def call(self, i: int):
        r = int(self.order[i % len(self.order)])
        with quiet():
            out = self.stac.fit_offsets(self.kp[r])
        return r, out.qpos, out.offsets, out.marker_sites

    def evaluate(self, records) -> dict:
        poses, fits = Tally(self.model), FitTally(self.model)
        for r, qpos, offsets, markers in records:
            poses.add_poses(self.fk, qpos, offsets, self.kp[r], self.frames_per_call, markers)
            fits.add(self.fk, offsets, self.true[r], qpos, self.kp[r], self.m_reg_coef)
        return {"e2e": {"residual_mm": poses.residual_mm(), "offset_err_mm": fits.offset_err_mm()},
                "numbers": dict(poses.numbers(), **fits.numbers()),
                "per_call": [dict(a, **b) for a, b in zip(poses.per_call, fits.per_call())]}
