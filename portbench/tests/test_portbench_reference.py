"""The plain reference against the program, in float64 at small sizes (the
tests may import the program; the benchmark's reference does not)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.harness.gen import animal_offsets, make_recording, substream
from portbench.reference.fk import FK, marker_residuals
from portbench.reference.model import Model
from portbench.reference.mphase import closed_form_offsets
from stac_mjx_tpu_torch.bridge import BUNDLE_PATH, fit_model_from_arrays, load_bundle
from stac_mjx_tpu_torch.models.kinematics import make_fk, make_fk_jump
from stac_mjx_tpu_torch.models.setup import model_setup
from stac_mjx_tpu_torch.ops.solver import m_opt_closed_form

MODEL = Model(BUNDLE_PATH)


def _poses(n=40, seed=5):
    fk = FK(MODEL, "cpu")
    rec = make_recording(fk, 2, n // 2, seed)
    q = rec["qpos"] + 0.05 * torch.randn(rec["qpos"].shape, generator=torch.Generator().manual_seed(seed),
                                          dtype=torch.float64)
    return fk, rec, q


@pytest.mark.parametrize("make", [make_fk, make_fk_jump], ids=["scan", "jump"])
def test_fk_matches_the_program_in_float64(make):
    fk, _, q = _poses()
    bundle = load_bundle(BUNDLE_PATH)
    fm = fit_model_from_arrays(bundle, "cpu", torch.float64)
    theirs = make(fm.topo, "cpu")(fm.params, q)
    ours = fk.frames(q)
    for key in ("xpos", "xquat", "xanchor", "xaxis"):
        assert float((getattr(theirs, key) - ours[key]).abs().max()) < 1e-12, key
    assert float((theirs.site_xpos - fk.site_positions(ours)).abs().max()) < 1e-12


def test_closed_form_offsets_match_the_program_in_float64():
    fk, rec, q = _poses(60)
    kp = rec["kp"].double()
    m0 = MODEL.initial_offsets()
    reg = MODEL.regularized()
    ours = closed_form_offsets(fk, q, kp, m0, reg, 1.0)
    fr = fk.frames(q)
    body = torch.as_tensor(MODEL.keypoint_bodies())
    from portbench.reference.fk import qmat

    theirs = m_opt_closed_form(fr["xpos"][:, body], qmat(fr["xquat"][:, body]), kp.reshape(len(q), -1, 3),
                               torch.as_tensor(m0), torch.as_tensor(np.repeat(reg[:, None], 3, 1), dtype=torch.float64),
                               1.0)
    assert np.abs(theirs.params.numpy() - ours).max() < 1e-12


def test_box_matches_the_program_setup():
    bundle = load_bundle(BUNDLE_PATH)
    setup = model_setup(MODEL.model_config, bundle)
    lb, ub = MODEL.box()
    assert np.array_equal(lb, setup["lb"]) and np.array_equal(ub, setup["ub"])
    assert np.array_equal(np.repeat(MODEL.regularized()[:, None], 3, 1).astype(float), setup["is_regularized"])


def test_generator_is_deterministic_per_seed_and_exact():
    fk = FK(MODEL, "cpu")
    seed = 2**31 + 12345
    a, b = make_recording(fk, 3, 20, seed), make_recording(fk, 3, 20, seed)
    c = make_recording(fk, 3, 20, seed + 1)
    assert torch.equal(a["kp"], b["kp"]) and np.array_equal(a["offsets"], b["offsets"])
    assert not torch.equal(a["kp"], c["kp"])
    lb, ub = MODEL.box()
    q = a["qpos"].numpy()
    assert (q >= lb).all() and (q <= ub).all(), "every true pose lies in the box"
    r = marker_residuals(fk, a["qpos"], a["offsets"], a["kp"])
    assert float(r.max()) < 1e-6, "the keypoints are the true poses' markers (float32 rounding)"
    assert substream(seed, 1) != substream(seed, 2)


def test_animals_are_fixed_and_distinct():
    a0, a0b, a1 = animal_offsets(MODEL, 0), animal_offsets(MODEL, 0), animal_offsets(MODEL, 1)
    assert np.array_equal(a0, a0b) and not np.array_equal(a0, a1)
    assert np.abs(a0 - MODEL.initial_offsets()).max() <= 0.008
