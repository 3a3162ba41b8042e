"""The FK kernel (``csrc/fk_jump.cu``) and what surrounds it.

On the CPU: the packed topology table (``kinematics.fk_table``) walked by a
numpy twin of the kernel, in float64 and in the kernel's order, against the
level-scan FK, and the dispatch rule of ``make_fk_jump``. On the card
(``cuda`` marker): the kernel against the plain body, batch invariance, a
changed ``site_pos``, the launch counter and an LM graph replay. Imports
neither jax nor the JAX package, so it also runs on the GPU machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fk_kernel.py
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from stac_mjx_tpu_torch import bridge
from stac_mjx_tpu_torch.models import kinematics as K
from stac_mjx_tpu_torch.utils.profiling import LAUNCHES

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

MODELS = ("firstparty", "synth_data", "fly_tethered")
FIELDS = ("xpos", "xquat", "site_xpos", "xanchor", "xaxis")


def _model(name, device="cpu", dtype=torch.float64):
    b = bridge.load_bundle(bridge.bundle_path(name))
    return b, bridge.fit_model_from_arrays(b, device, dtype)


def _qpos(b, frames, seed):
    """qpos0 plus noise (unnormalised free and ball quaternions); the first
    frame's quaternions all zero where it has more than one frame (mju_normalize4's
    fallback)."""
    rng = np.random.default_rng(seed)
    q = np.tile(b["qpos0"], (frames, 1)) + rng.normal(0, 0.4, (frames, len(b["qpos0"])))
    if frames > 1:
        for j, t in enumerate(b["jnt_type"]):
            a = int(b["jnt_qposadr"][j])
            if t == K.JNT_FREE:
                q[0, a + 3 : a + 7] = 0.0
            elif t == K.JNT_BALL:
                q[0, a : a + 4] = 0.0
    return q


# ----------------------------------------------------- the table (CPU)


def _rotate(q, v):
    u, w = q[..., 1:], q[..., :1]
    uv = np.cross(u, v)
    return v + 2.0 * (w * uv + np.cross(u, uv))


def _qmul(a, b):
    w1, x1, y1, z1 = np.moveaxis(a, -1, 0)
    w2, x2, y2, z2 = np.moveaxis(b, -1, 0)
    return np.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2, w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2, w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], -1)


def _normalize(q):
    n2 = np.sum(q * q, -1, keepdims=True)
    return np.where(n2 < 1e-30, [1.0, 0.0, 0.0, 0.0], q / np.sqrt(np.where(n2 < 1e-30, 1.0, n2)))


def _walk(packed, p, qpos):
    """The kernel's walk of ``fk_table``'s table in numpy, every frame at
    once: the local pass body by body, the tree pass level by level, then
    joints and sites. ``p``: the KinParams arrays as float64 numpy."""
    nbody, njnt, nsite, nq, nslot, nlevel = packed.dims
    tab = packed.table
    bcols = 2 + 3 * nslot
    bodies = tab[: nbody * bcols].reshape(nbody, bcols)
    order = tab[nbody * bcols : nbody * bcols + nbody - 1]
    starts = tab[nbody * bcols + nbody - 1 :][: nlevel + 1]
    rest = tab[nbody * bcols + nbody - 1 + nlevel + 1 :]
    jrows, site_body = rest[: 2 * njnt].reshape(njnt, 2), rest[2 * njnt :]
    assert len(site_body) == nsite
    F = qpos.shape[0]
    pos = np.zeros((F, nbody, 3))
    quat = np.zeros((F, nbody, 4))
    quat[:, 0, 0] = 1.0
    anc, axs = np.zeros((F, njnt, 3)), np.zeros((F, njnt, 3))
    for b in range(1, nbody):
        t = np.broadcast_to(p["body_pos"][b], (F, 3)).copy()
        q = np.broadcast_to(p["body_quat"][b], (F, 4)).copy()
        for s in range(nslot):
            typ, qa, j = bodies[b, 2 + 3 * s : 5 + 3 * s]
            if typ == K.JNT_NONE:
                break
            jpos, axis = p["jnt_pos"][j], p["jnt_axis"][j]
            if typ == K.JNT_FREE:
                t, q = qpos[:, qa : qa + 3].copy(), _normalize(qpos[:, qa + 3 : qa + 7])
                anc[:, j], axs[:, j] = t, axis
                continue
            anc[:, j], axs[:, j] = t + _rotate(q, jpos), _rotate(q, axis)
            dq = qpos[:, qa] - p["qpos0"][qa]
            if typ == K.JNT_SLIDE:
                t = t + axs[:, j] * dq[:, None]
                continue
            if typ == K.JNT_HINGE:
                local = np.concatenate([np.cos(0.5 * dq)[:, None], axis * np.sin(0.5 * dq)[:, None]], -1)
            else:
                local = _normalize(qpos[:, qa : qa + 4])
            q = _qmul(q, local)
            t = anc[:, j] - _rotate(q, jpos)
        pos[:, b], quat[:, b] = t, q
    for lv in range(nlevel):
        for b in order[starts[lv] : starts[lv + 1]]:
            pa = bodies[b, 0]
            pos[:, b] = pos[:, pa] + _rotate(quat[:, pa], pos[:, b])
            quat[:, b] = _normalize(_qmul(quat[:, pa], quat[:, b]))
    for j, (b, typ) in enumerate(jrows):
        if typ != K.JNT_FREE:
            pa = bodies[b, 0]
            anc[:, j] = pos[:, pa] + _rotate(quat[:, pa], anc[:, j])
            axs[:, j] = _rotate(quat[:, pa], axs[:, j])
    site = pos[:, site_body] + _rotate(quat[:, site_body], p["site_pos"])
    if not njnt:
        anc = axs = np.zeros((F, 1, 3))
    return dict(xpos=pos, xquat=quat, site_xpos=site, xanchor=anc, xaxis=axs)


@pytest.mark.parametrize("name", MODELS)
def test_table_walk_matches_the_level_scan_f64(name):
    """The table read in the kernel's order gives the level-scan FK in
    float64: a wrong slot, qpos address, parent, level or site body shows."""
    b, fm = _model(name)
    packed = K.fk_table(fm.topo)
    nbody, njnt, nsite, nq, nslot, nlevel = packed.dims
    assert packed.table.dtype == np.int32
    assert len(packed.table) == nbody * (2 + 3 * nslot) + nbody - 1 + nlevel + 1 + 2 * njnt + nsite
    assert (nbody, njnt, nsite, nq, nlevel) == (fm.topo.nbody, fm.topo.njnt, fm.topo.nsite, fm.topo.nq,
                                                fm.topo.n_levels)
    qs = _qpos(b, 12, seed=3)
    p = {f: getattr(fm.params, f).numpy() for f in ("body_pos", "body_quat", "jnt_pos", "jnt_axis", "qpos0",
                                                    "site_pos")}
    got = _walk(packed, p, qs)
    want = K.make_fk(fm.topo, "cpu")(fm.params, torch.as_tensor(qs))
    for f in FIELDS:
        np.testing.assert_allclose(got[f], getattr(want, f).numpy(), rtol=0, atol=1e-12, err_msg=f)


def test_table_of_a_tree_without_joints():
    """A jointless body: one slot column of padding, zero-joint sections."""
    topo = K.KinTopology(nq=0, nv=0, nbody=3, nsite=1, njnt=0, body_parentid=[0, 0, 1],
                         body_jntadr=[-1, -1, -1], body_jntnum=[0, 0, 0], jnt_type=np.zeros(0),
                         jnt_qposadr=np.zeros(0), jnt_bodyid=np.zeros(0), site_bodyid=[2],
                         body_names=["world", "a", "b"], jnt_names=[], site_names=["s"])
    packed = K.fk_table(topo)
    assert packed.dims == (3, 0, 1, 0, 1, 2)
    np.testing.assert_array_equal(packed.table, [0, 0, 4, 0, -1, 0, 1, 4, 0, -1, 1, 2, 4, 0, -1,
                                                 1, 2, 0, 1, 2, 2])


def test_table_refuses_a_child_before_its_parent():
    topo = K.KinTopology(nq=1, nv=1, nbody=3, nsite=0, njnt=1, body_parentid=[0, 2, 0],
                         body_jntadr=[-1, 0, -1], body_jntnum=[0, 1, 0], jnt_type=[K.JNT_HINGE],
                         jnt_qposadr=[0], jnt_bodyid=[1], site_bodyid=np.zeros(0),
                         body_names=["world", "a", "b"], jnt_names=["j"], site_names=[])
    with pytest.raises(ValueError, match="after its parent"):
        K.fk_table(topo)


# ---------------------------------------------------- dispatch (CPU)


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on a card: what the dispatch reads."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("case", ["cpu", "card", "qpos_grad", "params_grad", "grad_off"])
def test_dispatch_rule(case, monkeypatch):
    """A CPU tensor takes the plain body and launches nothing; every CUDA
    call launches the kernel once, and where autograd records (qpos or a
    KinParams tensor requiring grad) the gradient is the plain body's,
    recomputed in the backward without a launch."""
    b, fm = _model("firstparty")
    fk = K.make_fk_jump(fm.topo, "cpu")
    launched = []

    def kernel(table, dims, params, qpos):  # the kernel's results: the plain body's, off autograd
        launched.append(dims)
        with torch.no_grad():
            return fk.plain(params, qpos.as_subclass(torch.Tensor))

    monkeypatch.setattr(K, "fk_jump_cuda", kernel)
    q = torch.as_tensor(_qpos(b, 3, seed=1))
    params = fm.params
    if case != "cpu":
        q = q.as_subclass(_OnCard)
    if case in ("qpos_grad", "grad_off"):
        q.requires_grad_(True)
    if case == "params_grad":
        params = K.KinParams(**{**vars(params), "site_pos": params.site_pos.clone().requires_grad_(True)})
    if case == "grad_off":
        with torch.no_grad():
            out = fk(params, q)
    else:
        out = fk(params, q)
    assert launched == ([] if case == "cpu" else [K.fk_table(fm.topo).dims])
    want = fk.plain(fm.params, torch.as_tensor(_qpos(b, 3, seed=1)))
    for f in FIELDS:
        assert torch.equal(getattr(out, f).detach().as_subclass(torch.Tensor), getattr(want, f)), f
    if case in ("qpos_grad", "params_grad"):
        leaf = q if case == "qpos_grad" else params.site_pos
        (out.site_xpos.sum() + out.xanchor.square().sum()).backward()
        got = leaf.grad.as_subclass(torch.Tensor)
        leaf.grad = None
        plain = fk.plain(params, q)
        (plain.site_xpos.sum() + plain.xanchor.square().sum()).backward()
        assert len(launched) == 1 and torch.equal(got, leaf.grad.as_subclass(torch.Tensor))


def test_kernel_refuses_a_cpu_tensor():
    b, fm = _model("synth_data")
    with pytest.raises(ValueError, match="on a card"):
        K.make_fk_jump(fm.topo, "cpu").kernel(fm.params, torch.as_tensor(_qpos(b, 2, seed=0)))


# -------------------------------------------------------- on the card

# Frames of the card tests: one, a ragged block, the fit's, the critter
# ik's coarse pass, a session.
FRAMES = (1, 31, 1000, 23_040, 180_000)
# float32 against the plain body: the same formulas composed in another
# association (per body against pointer doubling), with fused multiply-adds,
# 5 (critter) to 9 (fly) levels deep. Each lies within ~1e-6 of float64
# (the plain body on the CPU, 5,000 frames: 7.3e-7 of the length scale on
# the fly's positions, 6.4e-7 on its axes), so the two within twice that,
# with room for the larger batches: F32_REL of the model's length scale (the
# largest |xpos| of its frames) for positions, F32_REL for the unit
# quaternions and axes. float64: within F64_REL.
F32_REL = 4e-6
F64_REL = 1e-12


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _card_model(name, device, dtype):
    b, fm = _model(name, device, dtype)
    return b, fm, K.make_fk_jump(fm.topo, device)


def _assert_close(got, want, rel):
    scale = float(want.xpos.abs().max())
    for f in FIELDS:
        atol = rel * (scale if f in ("xpos", "site_xpos", "xanchor") else 1.0)
        torch.testing.assert_close(getattr(got, f), getattr(want, f), rtol=0, atol=atol, msg=f)


@pytest.mark.cuda
@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_kernel_matches_plain(cuda_device, name, dtype):
    b, fm, fk = _card_model(name, cuda_device, dtype)
    for F in FRAMES:
        q = torch.as_tensor(_qpos(b, F, seed=F), device=cuda_device).to(dtype)
        before = LAUNCHES["fk_jump"]
        got = fk(fm.params, q)
        assert LAUNCHES["fk_jump"] == before + 1, F
        want = fk.plain(fm.params, q)
        for f in FIELDS:
            assert getattr(got, f).shape == getattr(want, f).shape and getattr(got, f).dtype == dtype, f
        _assert_close(got, want, F32_REL if dtype == torch.float32 else F64_REL)
        del got, want, q
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["firstparty", "fly_tethered"])
def test_a_frame_is_bitwise_the_same_in_any_batch(cuda_device, name):
    b, fm, fk = _card_model(name, cuda_device, torch.float32)
    q = torch.as_tensor(_qpos(b, 23_040, seed=5), device=cuda_device).float()
    full = fk(fm.params, q)
    for lo, hi in ((0, 1), (0, 31), (7, 107), (5_000, 5_001), (12_345, 23_040)):
        part = fk(fm.params, q[lo:hi])
        for f in FIELDS:
            assert torch.equal(getattr(part, f), getattr(full, f)[lo:hi]), (f, lo, hi)


@pytest.mark.cuda
def test_moved_sites_move_site_xpos(cuda_device):
    """The kernel reads site_pos each launch (an m-phase rewrites it)."""
    b, fm, fk = _card_model("firstparty", cuda_device, torch.float32)
    q = torch.as_tensor(_qpos(b, 100, seed=2), device=cuda_device).float()
    sites = torch.as_tensor(fm.site_idxs, device=cuda_device)
    moved = fm.params.set_site_pos(fm.params.site_pos[sites] + 3e-3, sites)
    before, after = fk(fm.params, q), fk(moved, q)
    assert not torch.equal(before.site_xpos[:, sites], after.site_xpos[:, sites])
    assert torch.equal(before.xpos, after.xpos)
    _assert_close(after, fk.plain(moved, q), F32_REL)


@pytest.mark.cuda
def test_kernel_under_autograd_and_refusals(cuda_device):
    """Recording autograd launches the kernel too (its outputs bitwise the
    unrecorded pass's), and the gradient is the plain body's, computed in
    the backward with no launch (to float32 rounding: the backward of the
    plain body's gathers adds with atomics, in no fixed order); the kernel
    refuses float16 and a frame state past its shared memory."""
    b, fm, fk = _card_model("firstparty", cuda_device, torch.float32)
    q = torch.as_tensor(_qpos(b, 8, seed=4), device=cuda_device).float().requires_grad_(True)
    before = LAUNCHES["fk_jump"]
    out = fk(fm.params, q)
    out.site_xpos.sum().backward()
    assert LAUNCHES["fk_jump"] == before + 1 and q.grad is not None
    with torch.no_grad():
        bare = fk(fm.params, q)
    assert LAUNCHES["fk_jump"] == before + 2
    for f in FIELDS:
        assert torch.equal(getattr(out, f), getattr(bare, f)), f
    got, q.grad = q.grad, None
    fk.plain(fm.params, q).site_xpos.sum().backward()
    torch.testing.assert_close(got, q.grad, rtol=1e-6, atol=1e-6 * float(q.grad.abs().max()))
    with pytest.raises(ValueError, match="float32 or float64"):
        fk(fm.params, q.detach().half())
    _, max_bytes = K._fk_kernel(torch.float32)
    nbody = max_bytes // (7 * 4) + 1  # a chain of bodies, one hinge each
    topo = K.KinTopology(nq=nbody - 1, nv=nbody - 1, nbody=nbody, nsite=0, njnt=nbody - 1,
                         body_parentid=[0] + list(range(nbody - 1)), body_jntadr=[-1] + list(range(nbody - 1)),
                         body_jntnum=[0] + [1] * (nbody - 1), jnt_type=[K.JNT_HINGE] * (nbody - 1),
                         jnt_qposadr=list(range(nbody - 1)), jnt_bodyid=list(range(1, nbody)),
                         site_bodyid=np.zeros(0), body_names=[str(i) for i in range(nbody)],
                         jnt_names=[str(i) for i in range(nbody - 1)], site_names=[])
    def zeros(*shape):
        return torch.zeros(shape, device=cuda_device)

    params = K.KinParams(body_pos=zeros(nbody, 3), body_quat=zeros(nbody, 4), jnt_axis=zeros(nbody - 1, 3),
                         jnt_pos=zeros(nbody - 1, 3), qpos0=zeros(nbody - 1), site_pos=zeros(0, 3),
                         site_quat=zeros(0, 4))
    with pytest.raises(ValueError, match="holds at most"):
        K.make_fk_jump(topo, cuda_device)(params, zeros(2, nbody - 1))


@pytest.mark.cuda
def test_pg_loss_and_gradient_replayed_through_the_kernel(cuda_device):
    """The PG path's loss and gradient (``solver.value_and_grad``) through the
    jump FK, captured and replayed by ``solver.graph_replay`` as PG with
    ``fk_impl=jump`` runs them: the kernel launches in the forward, and a
    replay gives the eager evaluation's loss bitwise and its gradient to
    float32 rounding (the plain body's backward adds with atomics)."""
    from stac_mjx_tpu_torch.ops import solver

    b, fm, fk = _card_model("firstparty", cuda_device, torch.float32)
    q = torch.as_tensor(_qpos(b, 64, seed=6), device=cuda_device).float()
    target = fk.plain(fm.params, q + 0.05).site_xpos

    def loss(x):
        return (fk(fm.params, x).site_xpos - target).square().sum(dim=(1, 2))

    replay = solver.graph_replay(lambda x: solver.value_and_grad(loss, x), q)
    f, g = replay(q)
    before = LAUNCHES["fk_jump"]
    f_eager, g_eager = solver.value_and_grad(loss, q)
    assert LAUNCHES["fk_jump"] == before + 1
    assert torch.equal(f, f_eager)
    torch.testing.assert_close(g, g_eager, rtol=1e-6, atol=1e-6 * float(g_eager.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("frames", [1, 250])
def test_lm_graph_replay_with_the_kernel_bitwise_as_eager(cuda_device, frames, monkeypatch):
    """An LM solve captured into a CUDA graph with the FK kernel inside:
    every replay bitwise the eager solve, and the counter counts the
    kernel's launches of eager and replayed solves alike (1 + 14 a solve)."""
    from stac_mjx_tpu_torch.ops import gn_ik

    b, fm, _ = _card_model("firstparty", cuda_device, torch.float32)
    g = gn_ik.GNIK(fm.topo, fm.site_idxs, cuda_device, maxiter=14)
    q_true = torch.as_tensor(_qpos(b, frames, seed=frames), device=cuda_device).float()
    kp = g.fk(fm.params, q_true).site_xpos[:, g._site_idxs].reshape(frames, -1)
    q0 = q_true + 0.1
    lb, ub = (torch.as_tensor(b[k], device=cuda_device).float() for k in ("lb", "ub"))
    qs, kps = torch.ones(44, dtype=torch.bool, device=cuda_device), torch.ones(69, device=cuda_device)

    def solve():
        if frames == 1:
            return g.solve(fm.params, kp[0], qs, kps, q0[0], lb, ub)
        return g.solve_batch(fm.params, kp, qs, kps, q0, lb, ub)

    runs, counts = [], []
    for _ in range(3):  # eager, captured and replayed, replayed
        before = LAUNCHES["fk_jump"]
        runs.append(solve())
        counts.append(LAUNCHES["fk_jump"] - before)
    assert any(isinstance(v, gn_ik._LMGraph) for v in g._graphs.values())
    monkeypatch.setattr(gn_ik, "_GRAPH_MAX_FRAMES", 0)
    before = LAUNCHES["fk_jump"]
    want = solve()
    assert counts == [15, 15, 15] and LAUNCHES["fk_jump"] - before == 15, counts
    for got in runs:
        for f in want._fields:
            assert torch.equal(getattr(got, f), getattr(want, f)), f
