"""The port's lockstep slice against the JAX package, in float64 on the CPU.

Same firstparty model, same recording, same float64 parameters through
``stac_mjx_tpu.pipeline`` (jitted, x64) and ``stac_mjx_tpu_torch.pipeline``:
the fit (root solve, 2 x (pose pass, m-phase), final pass) on 40 frames, and
the ik on 2 clips x 32 frames, hierarchical (stride 4 / fine 3) and flat.
float64 shows that the algorithm is the same, branch for branch; the float32
quality comparison is in test_torch_pipeline_f32.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import x64_mode
from _torch_common import THROUGHPUT, bridge, jax_stac, np64, torch_stac
from stac_mjx_tpu import pipeline as jpipe
from stac_mjx_tpu.models import firstparty as jfirstparty
from stac_mjx_tpu.models.builder import extract_model
from stac_mjx_tpu_torch import pipeline as tpipe

FIT = dict(THROUGHPUT, n_frames_per_clip=32)
MODEL = {"N_ITERS": 2}
HIER = {"ik_hier_stride": 4, "ik_hier_fine_iters": 3}


@pytest.fixture(scope="module")
def setup():
    """JAX Stac (for its core/static config), f32 recording, f64 model arrays."""
    js = jax_stac(FIT, MODEL)
    kp, _, _, _ = jfirstparty.make_recording(js.cfg, n_frames=64, seed=3, base_path=".")
    # Keypoints travel as float32 in both packages; both then compute in f64.
    kp64 = np.asarray(kp, np.float32).astype(np.float64)
    b = bridge.load_bundle()
    with x64_mode():
        _, p64 = extract_model(js._mj_model, dtype=jnp.float64)
    return js, kp64, b, p64


def _jax_bounds(b):
    return jnp.asarray(b["lb"]), jnp.asarray(b["ub"]), jnp.asarray(b["is_regularized"])


def test_fit_matches_jax_f64(setup):
    js, kp64, b, p64 = setup
    kp = kp64[:40]
    core, cfg = js.stac_core_obj, js._static_cfg
    with x64_mode():
        lb, ub, isr = _jax_bounds(b)
        jout = jax.device_get(
            jax.jit(
                lambda p, k: jpipe.fit_offsets_program(core, cfg, p, k, lb, ub, isr, return_full=False)
            )(p64, jnp.asarray(kp))
        )
    ts = torch_stac(FIT, MODEL, torch.float64)
    tout = tpipe.fit_offsets_program(
        ts.stac_core_obj, ts._static_cfg, ts.params, torch.as_tensor(kp),
        ts._lb, ts._ub, ts._is_regularized, return_full=False,
    )
    # Marker-space quantities are well conditioned: the two packages differ
    # only by float64 rounding (measured 4e-12 m offsets, 1e-12 m errors
    # before the final pass, 4e-9 m after it).
    np.testing.assert_allclose(np64(tout["offsets"]), jout["offsets"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(np64(tout["iter_frame_errors"]), jout["iter_frame_errors"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(np64(tout["iter_m_errors"]), jout["iter_m_errors"], rtol=1e-9)
    np.testing.assert_allclose(np64(tout["frame_error"]), jout["frame_error"], rtol=0, atol=1e-8)
    # qpos: 1e-5 rad. All frames but one agree to ~3e-10; in one frame the
    # tail ball joint's twist is nearly unobservable (both tail keypoints
    # sit almost on its axis), so a 1e-16 difference in the normal
    # equations moves it by ~3e-6 while its markers move by 4e-9 m.
    np.testing.assert_allclose(np64(tout["qpos"]), jout["qpos"], rtol=0, atol=1e-5)
    assert np.median(np.abs(np64(tout["qpos"]) - jout["qpos"]).max(-1)) < 1e-8


@pytest.mark.parametrize("extra", [HIER, {}], ids=["hier4-fine3", "flat"])
def test_ik_matches_jax_f64(setup, extra):
    _, kp64, b, p64 = setup
    cfg_d = dict(FIT, **extra)
    js = jax_stac(cfg_d)
    core, cfg = js.stac_core_obj, js._static_cfg
    bk = kp64.reshape(2, 32, -1)
    off = np.asarray(b["site_pos"])[b["site_idxs"]]
    with x64_mode():
        lb, ub, _ = _jax_bounds(b)
        jq, je = jax.device_get(
            jax.jit(
                lambda p, k, o: jpipe.ik_only_program(core, cfg, p, k, o, lb, ub, return_full=False)
            )(p64, jnp.asarray(bk), jnp.asarray(off))
        )
    ts = torch_stac(cfg_d, None, torch.float64)
    tq, te = tpipe.ik_only_program(
        ts.stac_core_obj, ts._static_cfg, ts.params, torch.as_tensor(bk),
        torch.as_tensor(off), ts._lb, ts._ub, return_full=False,
    )
    # Measured 3e-8 (hierarchical) and 5e-9 (flat) in qpos, 2e-11 m in the
    # per-frame errors: float64 rounding only, with a 30x margin.
    np.testing.assert_allclose(np64(tq), jq, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np64(te), je, rtol=0, atol=1e-9)


def test_interp_seeds_match_jax(setup):
    """The hierarchical seeds are the same elementwise operations in both
    packages; XLA's fused loop may round a multiply-add once where PyTorch
    rounds twice, so equality is to 2 ulp (measured: 1 ulp in 1% of entries)."""
    js = setup[0]
    rng = np.random.default_rng(0)
    qc = rng.normal(size=(2, 5, js.topo.nq))
    for dt in (np.float64, np.float32):
        with x64_mode():
            want = np.asarray(jpipe.interp_seeds(js.topo, jnp.asarray(qc.astype(dt)), 4, 19))
        got = tpipe.interp_seeds(js.topo, torch.as_tensor(qc.astype(dt)), 4, 19)
        np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=2)


def test_offset_optimization_matches_jax(setup):
    """The m-phase samples the frames JAX's PRNGKey(0) permutation picks (the
    port reproduces it bit for bit), and an injected sample gives the
    closed form on exactly those frames. Same float64 sums in another
    order: 1e-12 m."""
    js, kp64, b, p64 = setup
    core, cfg = js.stac_core_obj, js._static_cfg
    rng = np.random.default_rng(1)
    qposes = np.tile(np64(p64.qpos0), (64, 1)) + 0.05 * rng.normal(size=(64, js.topo.nq))
    off0 = np.asarray(b["site_pos"])[b["site_idxs"]]
    isr = np.asarray(b["is_regularized"])
    with x64_mode():
        _, j_off, j_err = jpipe.offset_optimization(
            core, cfg, p64, jnp.asarray(kp64), jnp.asarray(off0), jnp.asarray(qposes), jnp.asarray(isr)
        )
        idx = np.array([5, 0, 63, 17, 17, 40])
        jm = core.m_opt(p64, jnp.asarray(kp64[idx]), jnp.asarray(qposes[idx]), jnp.asarray(off0),
                        jnp.asarray(isr), cfg.m_reg_coef)
    ts = torch_stac(FIT, MODEL, torch.float64)
    args = (ts.stac_core_obj, ts._static_cfg, ts.params, torch.as_tensor(kp64),
            torch.as_tensor(off0), torch.as_tensor(qposes), torch.as_tensor(isr))
    new_params, t_off, t_err = tpipe.offset_optimization(*args)
    np.testing.assert_allclose(np64(t_off), np.asarray(j_off), rtol=0, atol=1e-12)
    np.testing.assert_allclose(float(t_err), float(j_err), rtol=1e-10)
    np.testing.assert_array_equal(np64(new_params.site_pos[ts.stac_core_obj.site_idxs_t]), np64(t_off))
    _, t_off_i, t_err_i = tpipe.offset_optimization(*args, sample_idx=idx)
    np.testing.assert_allclose(np64(t_off_i), np.asarray(jm.params), rtol=0, atol=1e-12)
    np.testing.assert_allclose(float(t_err_i), float(jm.error), rtol=1e-10)


@pytest.mark.parametrize("continuous", [False, True])
def test_batch_kp_data_matches_jax(continuous):
    """Clip batching on numpy and torch input: the same windows, including
    the wrap-padded last window of continuous mode."""
    from stac_mjx_tpu.utils.batching import batch_kp_data as jax_batch
    from stac_mjx_tpu_torch.utils.batching import batch_kp_data

    kp = np.arange(45 * 6, dtype=np.float32).reshape(45, 6)  # 3 whole clips of 15
    want = np.asarray(jax_batch(kp, 15, continuous=continuous))
    np.testing.assert_array_equal(batch_kp_data(kp, 15, continuous=continuous), want)
    np.testing.assert_array_equal(batch_kp_data(torch.as_tensor(kp), 15, continuous=continuous).numpy(), want)
    with pytest.raises(ValueError):
        batch_kp_data(kp[:10], 15, continuous=continuous)
