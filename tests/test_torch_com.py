"""The port's site FK and subtree centres of mass against the JAX package
and MuJoCo's own mj_comPos, and its checked-in body inertia against a fresh
compile."""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from conftest import x64_mode
from _torch_common import REPO
from stac_mjx_tpu.models.builder import extract_model as jax_extract_model
from stac_mjx_tpu.models.kinematics import make_site_fk as jax_make_site_fk
from stac_mjx_tpu.models.kinematics import subtree_com as jax_subtree_com
from stac_mjx_tpu_torch import bridge
from stac_mjx_tpu_torch.config import compose_config
from stac_mjx_tpu_torch.models import builder
from stac_mjx_tpu_torch.models.kinematics import make_fk, make_site_fk, subtree_com
from test_fk import MIXED_XML

CONFIGS = {"firstparty": ("firstparty", "firstparty"), "synth": ("synth_data", "stac_synth_data")}
T = 6  # frames per case


def _cfg(name):
    model, stac = CONFIGS[name]
    return compose_config(REPO / "configs", overrides=[f"model={model}", f"stac={stac}"])


def _mj_model(name) -> mujoco.MjModel:
    """The fitting model as the port's builder compiles it (keypoint sites,
    rescale), or the inline model with every joint type."""
    if name == "mixed":
        return mujoco.MjModel.from_xml_string(MIXED_XML)
    cfg = _cfg(name)
    return builder.build_body_spec(builder.resolve_mjcf(cfg.model, REPO), cfg.model).compile()


def _port_model(m, dtype):
    topo, arrays = builder.extract_model(m)
    return topo, bridge.params_from_arrays(arrays, "cpu", dtype)


def _qpos(m, seed=11) -> np.ndarray:
    """T poses about qpos0, quaternions left unnormalised (FK normalises them)."""
    rng = np.random.default_rng(seed)
    return m.qpos0 + rng.normal(0, 0.3, (T, m.nq))


@pytest.mark.parametrize("name", ["firstparty", "synth"])
def test_site_fk_matches_jax_f64(name):
    m = _mj_model(name)
    qs = _qpos(m)
    idx = np.arange(m.nsite)[::-1][: max(1, m.nsite - 2)].copy()  # a subset, out of order
    topo, params = _port_model(m, torch.float64)
    got = make_site_fk(topo, idx, "cpu")(params, torch.as_tensor(qs))
    assert got.shape == (T, len(idx), 3)
    with x64_mode():
        jtopo, jparams = jax_extract_model(m, dtype=jnp.float64)
        want = jax.vmap(jax_make_site_fk(jtopo, idx), in_axes=(None, 0))(jparams, jnp.asarray(qs))
        want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    # The same FK's site rows, bitwise.
    full = make_fk(topo, "cpu")(params, torch.as_tensor(qs)).site_xpos[:, idx]
    assert torch.equal(got, full)


@pytest.mark.parametrize("name", ["firstparty", "synth", "mixed"])
def test_subtree_com_matches_jax_f64(name):
    """Both packages on the same float64 body frames (the port's FK's)."""
    m = _mj_model(name)
    topo, params = _port_model(m, torch.float64)
    res = make_fk(topo, "cpu")(params, torch.as_tensor(_qpos(m)))
    got = subtree_com(topo, m.body_mass, m.body_ipos, "cpu")(res.xpos, res.xquat)
    assert got.shape == (T, m.nbody, 3) and got.dtype == torch.float64
    with x64_mode():
        jtopo, _ = jax_extract_model(m, dtype=jnp.float64)
        com = jax.vmap(jax_subtree_com(jtopo, m.body_mass, m.body_ipos))
        want = np.asarray(com(jnp.asarray(res.xpos.numpy()), jnp.asarray(res.xquat.numpy())))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", ["firstparty", "mixed"])
def test_subtree_com_matches_mujoco_f32(name):
    """float32 FK + subtree_com against mj_comPos's d.subtree_com, to
    tests/test_fk.py's bound (2e-5 m)."""
    m = _mj_model(name)
    d = mujoco.MjData(m)
    qs = _qpos(m)
    topo, params = _port_model(m, torch.float32)
    res = make_fk(topo, "cpu")(params, torch.as_tensor(qs, dtype=torch.float32))
    got = subtree_com(topo, m.body_mass, m.body_ipos, "cpu")(res.xpos, res.xquat).numpy()
    for t in range(T):
        d.qpos[:] = qs[t]
        mujoco.mj_kinematics(m, d)
        mujoco.mj_comPos(m, d)
        np.testing.assert_allclose(got[t], d.subtree_com, rtol=0, atol=2e-5)


def test_checked_in_inertia_matches_fresh_compile():
    """assets/firstparty_inertia.npz is regenerable: builder.body_inertia of
    a fresh compile (run scripts/export_torch_inertia.py after model edits)."""
    mass, ipos = builder.body_inertia(_cfg("firstparty"), REPO)
    stored_mass, stored_ipos = bridge.load_inertia()
    assert stored_mass.dtype == mass.dtype == np.float64 and stored_ipos.shape == (mass.shape[0], 3)
    np.testing.assert_array_equal(stored_mass, mass)
    np.testing.assert_array_equal(stored_ipos, ipos)
    m = _mj_model("firstparty")
    np.testing.assert_array_equal(mass, m.body_mass)
    np.testing.assert_array_equal(ipos, m.body_ipos)


def test_entry_points_default_to_the_card():
    """Without a device both build on the card; with no card they raise."""
    m = _mj_model("mixed")
    topo, _ = _port_model(m, torch.float32)
    for make in (lambda: make_site_fk(topo, [0]), lambda: subtree_com(topo, m.body_mass, m.body_ipos)):
        if torch.cuda.is_available():
            assert callable(make())
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()
