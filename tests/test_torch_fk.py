"""The port's quaternion math and pointer-doubling FK against the JAX package
and MuJoCo's own mj_kinematics."""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from conftest import x64_mode
from _torch_common import REPO, jax_stac, np64
from stac_mjx_tpu.models.builder import extract_model
from stac_mjx_tpu.models.kinematics import make_fk_jump as jax_make_fk_jump
from stac_mjx_tpu.ops import gn_ik as jax_gn_ik
from stac_mjx_tpu.ops import quat as jq
from stac_mjx_tpu_torch import bridge
from stac_mjx_tpu_torch.bridge import KINPARAMS_FIELDS, TOPOLOGY_FIELDS
from stac_mjx_tpu_torch.models.kinematics import make_fk_jump
from stac_mjx_tpu_torch.ops import quat as tq

FK_FIELDS = ("xpos", "xquat", "site_xpos", "xanchor", "xaxis")


def _quats(rng, shape):
    q = rng.normal(size=shape + (4,))
    q[0, 0] = 0.0  # a degenerate quaternion: mju_normalize4 gives [1, 0, 0, 0]
    return q


def test_quat_functions_match_jax_f64():
    rng = np.random.default_rng(0)
    q1, q2 = _quats(rng, (3, 5)), rng.normal(size=(3, 5, 4))
    v = rng.normal(size=(3, 5, 3))
    axis = v / np.linalg.norm(v, axis=-1, keepdims=True)
    angle = rng.uniform(-3, 3, size=(3, 5))
    unit = q2 / np.linalg.norm(q2, axis=-1, keepdims=True)
    unit[0, 0] = [np.cos(np.pi / 2), 0.0, 0.0, 1.0]  # an exact +pi rotation
    unit[0, 1] = [1.0, 0.0, 0.0, 0.0]  # the identity
    rv = 0.3 * rng.normal(size=(3, 5, 3))
    rv[0, :2] = [[1e-9, 0, 0], [0, 0, 0]]  # the small-angle series branch
    cases = [
        ("quat_mul", (q1, q2)),
        ("quat_conj", (q1,)),
        ("quat_diff", (q1, q2)),
        ("quat_rotate", (q2, v)),
        ("quat_rotate_inv", (q2, v)),
        ("quat_normalize", (q1,)),
        ("axis_angle_quat", (axis, angle)),
        ("quat_to_mat", (q2,)),
        ("quat_to_axisangle", (unit,)),
    ]
    with x64_mode():
        for name, args in cases:
            want = np.asarray(getattr(jq, name)(*(jnp.asarray(a) for a in args)))
            got = getattr(tq, name)(*(torch.as_tensor(a) for a in args)).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14, err_msg=name)
        want = np.asarray(jax_gn_ik.quat_exp(jnp.asarray(rv)))
    np.testing.assert_allclose(tq.quat_exp(torch.as_tensor(rv)).numpy(), want, rtol=1e-12, atol=1e-15)


def _jax_model(xml, dtype):
    m = mujoco.MjModel.from_xml_path(str(xml)) if not isinstance(xml, mujoco.MjModel) else xml
    topo, params = extract_model(m, dtype=dtype)
    return m, topo, params


def _port_from_jax(topo, params, dtype):
    """The port's topology/params from the JAX objects, through the bridge."""
    arrays = {k: getattr(topo, k) for k in TOPOLOGY_FIELDS}
    arrays.update({k: np.asarray(getattr(params, k)) for k in KINPARAMS_FIELDS})
    return bridge.topology_from_arrays(arrays), bridge.params_from_arrays(arrays, "cpu", dtype)


def _random_qpos(m, rng, n=16):
    return np.tile(m.qpos0, (n, 1)) + rng.normal(0, 0.4, (n, m.nq))


@pytest.mark.parametrize("xml", ["firstparty", "synth"])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_fk_jump_matches_jax(xml, dtype):
    # float64: both are exact compositions of the same operations, <1e-12;
    # float32: atol 2e-5, the bounds tests/test_fk.py uses.
    jdt, tdt, tol = {
        "f64": (jnp.float64, torch.float64, 1e-12),
        "f32": (jnp.float32, torch.float32, 2e-5),
    }[dtype]
    path = REPO / "models" / f"{xml}.xml"
    rng = np.random.default_rng(1)
    with x64_mode():
        m, topo, params = _jax_model(path, jdt)
        qs = _random_qpos(m, rng)
        res = jax.jit(jax.vmap(jax_make_fk_jump(topo), in_axes=(None, 0)))(params, jnp.asarray(qs, jdt))
        want = {f: np.asarray(getattr(res, f)) for f in FK_FIELDS}
    ttopo, tparams = _port_from_jax(topo, params, tdt)
    got = make_fk_jump(ttopo, "cpu")(tparams, torch.as_tensor(qs).to(tdt))
    for f in FK_FIELDS:
        np.testing.assert_allclose(np64(getattr(got, f)), want[f], rtol=0, atol=tol, err_msg=f)


def test_bundle_model_matches_mujoco():
    """The checked-in bundle, through the port's FK, against mj_kinematics
    on the model the JAX package builds (sites attached, rescaled)."""
    m = jax_stac({})._mj_model
    fm = bridge.fit_model_from_arrays(bridge.load_bundle(), "cpu", torch.float64)
    rng = np.random.default_rng(2)
    qs = _random_qpos(m, rng, n=6)
    res = make_fk_jump(fm.topo, "cpu")(fm.params, torch.as_tensor(qs))
    d = mujoco.MjData(m)
    for i, q in enumerate(qs):
        d.qpos[:] = q
        mujoco.mj_kinematics(m, d)
        for f, want in (("xpos", d.xpos), ("xquat", d.xquat), ("site_xpos", d.site_xpos),
                        ("xanchor", d.xanchor), ("xaxis", d.xaxis)):
            np.testing.assert_allclose(np64(getattr(res, f)[i]), want, rtol=0, atol=1e-12, err_msg=f)
    np.testing.assert_array_equal(fm.site_idxs, [m.site(n).id for n in bridge.load_bundle()["kp_names"]])
