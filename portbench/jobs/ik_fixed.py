"""ik_fixed: ``ik``'s job (one ``Stac.ik_only`` call per job, poses of every
frame of a session at known offsets) on sessions that do not depend on the
run's seed.

Traffic keys as ``ik``'s. The ``pool`` sessions come from fixed keys,
``substream(0, 5, i)`` for session i, at animal ``animal``'s offsets; the
seed only chooses the session the calls start on. A body with many joints
poses most frames to float32's floor and a few frames far off it, and the
few set the mean residual: on sessions drawn from the seed the mean swings
with the seed, while the same sessions in any order pose the same frames.

``residual_mm`` is the mean over the pool's sessions of each session's
mean residual, so that the session the window's odd call falls on does not
weigh more. The configuration's ``length_unit_m`` (a body modelled in cm:
0.01) turns the model's length unit into metres: ``harness/check.py``
reports model units times 1e3 as mm, so the residual and every ``*_mm``
(``*_um``) number it reports is multiplied by it, and reads true mm (um).

Set-up prints, on standard error, the process's age when the job starts,
then the seconds the ``Stac`` with the reference and the sessions took.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from portbench.harness import env, measure
from portbench.harness.check import Tally
from portbench.harness.gen import animal_offsets, make_recording, substream
from portbench.harness.job import Job as Base
from portbench.harness.job import quiet


class Job(Base):
    def __init__(self, cell, seed, device, control=False):
        age, t0 = env.process_age_s(), time.time()
        super().__init__(cell, seed, device, control)
        t1 = time.time()
        tr = self.traffic
        clips, clip_frames = int(tr["clips"]), int(tr["clip_frames"])
        per_clip = int(self.cfg["stac"]["n_frames_per_clip"])
        self.unit = float(self.cfg.get("length_unit_m", 1.0))
        self.kp, self.offsets = [], []
        animal = animal_offsets(self.model, int(tr["animal"]))
        for i in range(int(tr["pool"])):
            rec = make_recording(self.fk, clips, clip_frames, substream(0, 5, i), float(tr.get("noise_m", 0.0)),
                                 offsets=animal)
            kp = rec["kp"].reshape(clips, clip_frames, -1)[:, :per_clip].reshape(clips * per_clip, -1)
            self.kp.append(self.to_host(kp))
            self.offsets.append(rec["offsets"])
            del rec, kp
        self.frames_per_call = clips * per_clip
        self.first = substream(seed, 6) % len(self.kp)
        measure.sync(self.device)
        print(f"portbench: ik_fixed set-up: process age {age:.2f} s at the job's start, Stac and reference "
              f"{t1 - t0:.2f} s, {len(self.kp)} sessions {time.time() - t1:.2f} s", file=sys.stderr)

    def call(self, i: int):
        r = (self.first + i) % len(self.kp)
        with quiet():
            out = self.stac.ik_only(self.kp[r], self.offsets[r])
        return r, out.qpos, out.marker_sites

    def _in_unit(self, numbers: dict) -> dict:
        return {k: v * self.unit if k.endswith(("_mm", "_um")) else v for k, v in numbers.items()}

    def evaluate(self, records) -> dict:
        tally, sessions = Tally(self.model), {}  # session -> [marker residual sum, markers]
        for r, qpos, markers in records:
            before = tally.marker_sum, tally.marker_n
            tally.add_poses(self.fk, qpos, self.offsets[r], self.kp[r], self.frames_per_call, markers)
            acc = sessions.setdefault(r, [0.0, 0])
            acc[0] += tally.marker_sum - before[0]
            acc[1] += tally.marker_n - before[1]
        means = [1e3 * s / n for s, n in sessions.values() if n]
        resid = float(np.mean(means)) if means and len(means) == len(sessions) else float("inf")
        return {"e2e": {"residual_mm": resid * self.unit}, "numbers": self._in_unit(tally.numbers()),
                "per_call": [self._in_unit(n) for n in tally.per_call]}
