"""ik: pose every frame of a session at known offsets, one ``Stac.ik_only``
call per job (host float32 keypoints in, numpy poses out).

Traffic keys: ``clips`` and ``clip_frames`` (the session: clips of that
many frames), ``animal`` (whose session it is), ``pool`` (sessions made in
set-up; the calls cycle over them), ``noise_m``. Each call poses the first ``n_frames_per_clip`` frames
(the configuration's) of every clip. The offsets are the generator's true
ones, so no fit runs.
"""

from __future__ import annotations

from portbench.harness.check import Tally
from portbench.harness.gen import animal_offsets, make_recording, substream
from portbench.harness.job import Job as Base
from portbench.harness.job import quiet


class Job(Base):
    def __init__(self, cell, seed, device, control=False):
        super().__init__(cell, seed, device, control)
        tr = self.traffic
        clips, clip_frames = int(tr["clips"]), int(tr["clip_frames"])
        per_clip = int(self.cfg["stac"]["n_frames_per_clip"])
        self.kp, self.offsets = [], []
        animal = animal_offsets(self.model, int(tr["animal"]))
        for i in range(int(tr["pool"])):
            rec = make_recording(self.fk, clips, clip_frames, substream(seed, 1, i), float(tr.get("noise_m", 0.0)),
                                 offsets=animal)
            kp = rec["kp"].reshape(clips, clip_frames, -1)[:, :per_clip].reshape(clips * per_clip, -1)
            self.kp.append(self.to_host(kp))
            self.offsets.append(rec["offsets"])
            del rec, kp
        self.frames_per_call = clips * per_clip

    def call(self, i: int):
        r = i % len(self.kp)
        with quiet():
            out = self.stac.ik_only(self.kp[r], self.offsets[r])
        return r, out.qpos, out.marker_sites

    def evaluate(self, records) -> dict:
        tally = Tally(self.model)
        for r, qpos, markers in records:
            tally.add_poses(self.fk, qpos, self.offsets[r], self.kp[r], self.frames_per_call, markers)
        return {"e2e": {"residual_mm": tally.residual_mm()}, "numbers": tally.numbers(),
                "per_call": tally.per_call}
