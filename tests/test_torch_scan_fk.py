"""The port's level-scan FK and the gradients the projected-gradient solvers
take through it, against the JAX package, in float64 on the CPU: the level
tables, ``make_fk`` against JAX ``make_fk`` and the port's ``make_fk_jump``
(degenerate quaternions included), autograd through the quaternion functions
against ``jax.grad`` (at their degenerate points too), and the gradient of
``StacCore.q_loss`` through both FKs."""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from conftest import x64_mode
from _torch_common import REPO, jax_stac, np64
from stac_mjx_tpu.models.builder import extract_model
from stac_mjx_tpu.models.kinematics import make_fk as jax_make_fk
from stac_mjx_tpu.ops import quat as jq
from stac_mjx_tpu_torch import bridge
from stac_mjx_tpu_torch.bridge import KINPARAMS_FIELDS, TOPOLOGY_FIELDS
from stac_mjx_tpu_torch.models.kinematics import make_fk, make_fk_jump
from stac_mjx_tpu_torch.ops import quat as tq
from stac_mjx_tpu_torch.ops.stac_core import StacCore

FK_FIELDS = ("xpos", "xquat", "site_xpos", "xanchor", "xaxis")
LEVEL_TABLES = ("lv_body", "lv_parent", "lv_jid", "lv_jtype", "lv_qadr", "slot_flat_idx", "slot_flat_jid")


def _model(name):
    with x64_mode():
        m = mujoco.MjModel.from_xml_path(str(REPO / "models" / f"{name}.xml"))
        topo, params = extract_model(m, dtype=jnp.float64)
    arrays = {k: getattr(topo, k) for k in TOPOLOGY_FIELDS}
    arrays.update({k: np.asarray(getattr(params, k)) for k in KINPARAMS_FIELDS})
    return m, topo, params, bridge.topology_from_arrays(arrays), bridge.params_from_arrays(arrays, "cpu", torch.float64)


def _degenerate_qpos(m, topo, rng, n=12):
    """Random poses; frame 0 has an all-zero free quaternion, frame 1 all-zero
    ball quaternions, frame 2 every hinge/slide at its qpos0."""
    qs = np.tile(m.qpos0, (n, 1)) + rng.normal(0, 0.4, (n, m.nq))
    for j, (t, a) in enumerate(zip(topo.jnt_type, topo.jnt_qposadr)):
        if t == 0:
            qs[0, a + 3 : a + 7] = 0.0
        elif t == 1:
            qs[1, a : a + 4] = 0.0
        else:
            qs[2, a] = m.qpos0[a]
    return qs


@pytest.mark.parametrize("name", ["firstparty", "synth"])
def test_level_tables_match_jax(name):
    _, topo, _, ttopo, _ = _model(name)
    assert (ttopo.n_levels, ttopo.level_pad) == (topo.n_levels, topo.level_pad)
    assert [list(a) for a in ttopo.levels] == [list(a) for a in topo.levels]
    for k in LEVEL_TABLES:
        np.testing.assert_array_equal(getattr(ttopo, k), getattr(topo, k), err_msg=k)


@pytest.mark.parametrize("name", ["firstparty", "synth"])
def test_fk_scan_matches_jax_and_jump_f64(name):
    # Both are compositions of the same float64 operations: 1e-12.
    m, topo, params, ttopo, tparams = _model(name)
    qs = _degenerate_qpos(m, topo, np.random.default_rng(0))
    with x64_mode():
        res = jax.jit(jax.vmap(jax_make_fk(topo), in_axes=(None, 0)))(params, jnp.asarray(qs))
        want = {f: np.asarray(getattr(res, f)) for f in FK_FIELDS}
    got = make_fk(ttopo, "cpu")(tparams, torch.as_tensor(qs))
    jump = make_fk_jump(ttopo, "cpu")(tparams, torch.as_tensor(qs))
    for f in FK_FIELDS:
        np.testing.assert_allclose(np64(getattr(got, f)), want[f], rtol=0, atol=1e-12, err_msg=f)
        np.testing.assert_allclose(np64(getattr(got, f)), np64(getattr(jump, f)), rtol=0, atol=1e-12, err_msg=f)


def _quat_cases(rng):
    q = rng.normal(size=(6, 4))
    q[0] = 0.0  # mju_normalize4's degenerate branch
    v = rng.normal(size=(6, 3))
    axis = v / np.linalg.norm(v, axis=-1, keepdims=True)
    angle = rng.uniform(-3, 3, size=6)
    angle[0] = 0.0  # a hinge at its reference angle
    return {
        "quat_normalize": (q,),
        "axis_angle_quat": (axis, angle),
        "quat_rotate": (rng.normal(size=(6, 4)), v),
        "quat_mul": (q, rng.normal(size=(6, 4))),
    }


@pytest.mark.parametrize("fn", ["quat_normalize", "axis_angle_quat", "quat_rotate", "quat_mul"])
def test_quat_gradients_match_jax(fn):
    """Autograd through the port's function against jax.grad through the
    JAX one, for a random weighting of the outputs; the degenerate points
    (zero quaternion, zero angle) are in the batch, and their gradients are
    finite in both. Same float64 operations: rtol 1e-12."""
    rng = np.random.default_rng(1)
    args = _quat_cases(rng)[fn]
    w = rng.normal(size=getattr(tq, fn)(*(torch.as_tensor(a) for a in args)).shape)
    with x64_mode():
        want = jax.grad(lambda *a: jnp.sum(getattr(jq, fn)(*a) * w), argnums=tuple(range(len(args))))(
            *(jnp.asarray(a) for a in args)
        )
    ts = [torch.as_tensor(a).requires_grad_(True) for a in args]
    got = torch.autograd.grad(torch.sum(getattr(tq, fn)(*ts) * torch.as_tensor(w)), ts)
    for g, wg in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("fk_impl", ["scan", "jump"])
def test_q_loss_gradient_matches_jax(fk_impl):
    """The projected-gradient solvers' gradient: autograd of the port's
    q_loss against jax.grad of the JAX one, per lane, through either FK;
    lane 0 has an all-zero free quaternion (finite gradient), the others
    random poses, masks and keypoints. 1e-10 relative."""
    js = jax_stac({"fk_impl": fk_impl})
    b = bridge.load_bundle()
    rng = np.random.default_rng(2)
    B = 5
    q = np.tile(b["qpos0"], (B, 1)) + rng.normal(0, 0.3, (B, 44))
    q[0, 3:7] = 0.0
    q0 = q + rng.normal(0, 0.1, (B, 44))
    kp = rng.normal(0, 0.05, (B, 69)) + np.tile(b["site_pos"][b["site_idxs"]].ravel(), (B, 1))
    qs = rng.uniform(size=44) > 0.2
    kps = (rng.uniform(size=69) > 0.1).astype(np.float64)
    core = js.stac_core_obj
    with x64_mode():
        _, p64 = extract_model(js._mj_model, dtype=jnp.float64)
        grad = jax.vmap(jax.grad(lambda x, k, i: core.q_loss(x, p64, k, jnp.asarray(qs), jnp.asarray(kps), i)))
        want = np.asarray(grad(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(q0)))
    fm = bridge.fit_model_from_arrays(b, "cpu", torch.float64)
    tcore = StacCore(fm.topo, fm.site_idxs, "cpu", fk_impl=fk_impl)
    qt = torch.as_tensor(q).requires_grad_(True)
    loss = tcore.q_loss(qt, fm.params, torch.as_tensor(kp), torch.as_tensor(qs), torch.as_tensor(kps),
                        torch.as_tensor(q0))
    (got,) = torch.autograd.grad(loss.sum(), qt)
    assert torch.isfinite(got).all()
    scale = np.abs(want).max(axis=1, keepdims=True)
    np.testing.assert_array_less(np.abs(got.numpy() - want) / scale, 1e-10)
    np.testing.assert_array_equal(got.numpy()[:, ~qs], 0.0)
