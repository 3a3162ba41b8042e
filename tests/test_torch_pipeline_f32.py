"""The port's slice against the JAX package in float32, through the user
entry points (``Stac.fit_offsets`` / ``Stac.ik_only``) of both packages.

float32 rounds differently in the two packages and can flip an LM accept
branch, so they are held by quality, not by iterate: the mean marker
residual and the offset error against the recording's ground truth.
"""

import dataclasses

import numpy as np
import pytest

from _torch_common import THROUGHPUT, jax_stac, torch_stac
from stac_mjx_tpu.models import firstparty as jfirstparty

CFG = dict(
    THROUGHPUT,
    n_frames_per_clip=32,
    ik_hier_stride=4,
    ik_hier_fine_iters=3,
    ik_return_full=False,
)
MODEL = {"N_ITERS": 2}
N_FIT, N_IK = 40, 64


def _resid(markers, kp, n):
    return float(np.linalg.norm(np.reshape(markers, (n, -1, 3)) - np.reshape(kp, (n, -1, 3)), axis=-1).mean())


@pytest.fixture(scope="module")
def runs():
    js, ts = jax_stac(CFG, MODEL), torch_stac(CFG, MODEL)
    kp, _, true_off, _ = jfirstparty.make_recording(js.cfg, n_frames=N_IK, seed=3, base_path=".")
    kp = np.asarray(kp)
    fits = {name: s.fit_offsets(kp[:N_FIT], return_full=True) for name, s in (("jax", js), ("torch", ts))}
    iks = {name: s.ik_only(kp, fits[name].offsets) for name, s in (("jax", js), ("torch", ts))}
    return dict(stacs={"jax": js, "torch": ts}, kp=kp, true_off=true_off, fits=fits, iks=iks)


def test_fit_quality_matches_jax_f32(runs):
    fits = runs["fits"]
    r = {k: _resid(f.marker_sites, f.kp_data, N_FIT) for k, f in fits.items()}
    # Mean marker residual within 2% of JAX's (measured: 0.02%).
    assert abs(r["torch"] - r["jax"]) <= 0.02 * r["jax"], r
    # Offset error against the ground truth no worse than JAX's + 10%.
    err = {k: float(np.abs(f.offsets - runs["true_off"]).mean()) for k, f in fits.items()}
    assert err["torch"] <= 1.1 * err["jax"], err
    assert fits["torch"].qpos.shape == fits["jax"].qpos.shape == (N_FIT, 44)
    assert np.isfinite(fits["torch"].qpos).all()


def test_ik_quality_matches_jax_f32(runs):
    iks, kp = runs["iks"], runs["kp"]
    r = {}
    for k, d in iks.items():
        _, _, markers = runs["stacs"][k].compute_full_outputs(d.qpos)
        r[k] = _resid(markers, kp, N_IK)
    # Hierarchical ik (stride 4 / fine 3) from each package's own fitted
    # offsets: mean residual within 2% of JAX's (measured: 0.01%).
    assert abs(r["torch"] - r["jax"]) <= 0.02 * r["jax"], r
    t, j = iks["torch"], iks["jax"]
    assert t.qpos.shape == j.qpos.shape == (N_IK, 44)
    assert t.xpos.size == 0 and t.kp_data.shape == j.kp_data.shape
    assert t.names_qpos == j.names_qpos and t.kp_names == j.kp_names
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]


def test_full_payload_matches_compute_full_outputs(runs):
    """return_full=True packages what compute_full_outputs derives, with the
    JAX package's order='F' flattening of batched xpos/xquat."""
    ts = runs["stacs"]["torch"]
    full = ts.ik_only(runs["kp"], runs["fits"]["torch"].offsets, return_full=True)
    lean = runs["iks"]["torch"]
    np.testing.assert_array_equal(full.qpos, lean.qpos)
    xpos, xquat, markers = ts.compute_full_outputs(full.qpos)
    np.testing.assert_allclose(full.marker_sites, markers, rtol=0, atol=1e-7)
    C, Fc = 2, 32
    want = xpos.reshape(C, Fc, *xpos.shape[1:]).reshape(-1, *xpos.shape[1:], order="F")
    np.testing.assert_allclose(full.xpos, want, rtol=0, atol=1e-7)
    assert full.xquat.shape == xquat.shape
