"""The port's lockstep part passes against the JAX package, in float64 on
the CPU: the batched schedule (parts on the batch axis, a mask per item,
write-back in part order) and the chain that the batched schedule falls back
to above ``_PART_BATCH_MAX_ITEMS`` (lowered in both packages); the set-up is
in ``_torch_parts.py``, the chain asked for in ``test_torch_parts_chain.py``."""

import pytest
import torch

from _torch_common import THROUGHPUT, torch_stac
from _torch_parts import FC, MODEL, N_FIT, SCHEDULES, check_against_jax, recording
from stac_mjx_tpu_torch import pipeline as tpipe


@pytest.fixture(scope="module")
def setup():
    return recording()


def test_batched_part_passes_match_jax_f64(setup, monkeypatch):
    check_against_jax(setup, "batched", monkeypatch)


def test_over_cap_ik_matches_jax_f64(setup, monkeypatch):
    """Over the cap, both packages chain the ik's part passes."""
    check_against_jax(setup, "over-cap", monkeypatch, fit=False)


def test_over_cap_falls_back_to_the_chain(setup, monkeypatch):
    """Above the cap the batched schedule is the chain, result for result."""
    kp, _, _ = setup
    out = {}
    for schedule in ("chain", "over-cap"):
        extra, cap = SCHEDULES[schedule]
        if cap is not None:
            monkeypatch.setattr(tpipe, "_PART_BATCH_MAX_ITEMS", cap)
        ts = torch_stac(dict(THROUGHPUT, skip_part_opt=False, n_frames_per_clip=FC, **extra), MODEL, torch.float64)
        out[schedule] = tpipe.fit_offsets_program(
            ts.stac_core_obj, ts._static_cfg, ts.params, torch.as_tensor(kp[:N_FIT]),
            ts._lb, ts._ub, ts._is_regularized, return_full=False,
        )
    for k in ("qpos", "offsets"):
        torch.testing.assert_close(out["over-cap"][k], out["chain"][k], rtol=0, atol=0)
