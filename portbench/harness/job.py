"""What every job runner shares: the configuration's ``Stac`` built from the
model bundle, the reference model and FK, and a sink for the program's
prints."""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from portbench.harness import control as control_mod
from portbench.harness.env import ROOT
from portbench.reference.fk import FK
from portbench.reference.model import Model


@contextlib.contextmanager
def quiet():
    """The program's own prints (one line per call) go to the null device."""
    with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
        yield


class Job:
    """A configuration's ``Stac`` on ``device``, with the reference beside it.

    Subclasses make their inputs in ``__init__``, and define ``call(i)``
    (one whole job, returning what the check reads), ``evaluate(records)``
    ({"e2e": {...}, "numbers": {...}}) and the counts ``frames_per_call``
    and ``fits_per_call``."""

    frames_per_call = 0
    fits_per_call = 0

    def __init__(self, cell, seed: int, device, control: bool = False):
        from stac_mjx_tpu_torch.stac import Stac

        self.cell, self.cfg, self.traffic, self.seed = cell, cell.config, cell.traffic, int(seed)
        self.device = torch.device(device)
        self.model = Model(ROOT / self.cfg["bundle"])
        self.fk = FK(self.model, self.device)
        self.m_reg_coef = float(self.cfg["model"]["M_REG_COEF"])
        with quiet():
            self.stac = Stac(self.model.arrays, self.cfg["stac"], model=self.cfg["model"], device=self.device,
                             dtype=getattr(torch, self.cfg["dtype"]))
        if control:
            control_mod.install(self.stac, self.model)

    def start_window(self) -> None:
        """Called once set-up (with its warm call) is over."""

    def rates(self, calls: int, wall: float) -> dict:
        """The window's end-to-end rates: frames posed per second, or
        seconds per fit."""
        if self.fits_per_call:
            return {"fit_s": wall / max(calls * self.fits_per_call, 1)}
        return {"ik_fps": calls * self.frames_per_call / wall}

    def to_host(self, kp: torch.Tensor) -> np.ndarray:
        """The job's input as a user hands it over: a host float32 array."""
        return kp.cpu().numpy()

    def release(self) -> None:
        """Frees the program's state before the reference runs."""
        self.stac = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
