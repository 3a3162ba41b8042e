"""The flat LM's CUDA-graph cache (``gn_ik.GNIK._flat_lm``) on the CPU.

The CPU has no CUDA graphs, so ``_EagerGraph`` stands in for ``_LMGraph``:
the same static inputs, copy-in, launch accounting and cloned outputs, with
the graph's capture and replay each an eager run of the solve. The tests
hold which solves are graphed (first sight eager, second captured and
replayed, later replayed), what the key tells apart, the cache's bound, and
that the eager loop's results are bitwise those of the loop before the
cache existed (``goldens/torch_flat_lm.npz``, written by the flat LM as it
stood then, inputs included). ``test_torch_cuda.py`` holds the real graphs
against eager solves on the card.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_common import bridge
from stac_mjx_tpu_torch.ops import gn_ik, spd
from stac_mjx_tpu_torch.utils import profiling

GOLDEN = Path(__file__).parent / "goldens" / "torch_flat_lm.npz"
NQ, M = 44, 69


class _EagerGraph(gn_ik._LMGraph):
    """``_LMGraph`` with its capture and replay run eagerly: the capture
    runs the solve once (as a capture, it counts its launches and the
    constructor takes them back), a replay runs it again into the outputs
    and leaves the launch count to ``__call__``."""

    made: list = []

    def _capture(self, run):
        self.run, self.replays = run, 0
        _EagerGraph.made.append(self)
        return run()

    def _replay(self):
        before = spd.KERNEL_LAUNCHES
        for o, n in zip(self.out, self.run()):
            o.copy_(n)
        spd.KERNEL_LAUNCHES = before
        self.replays += 1


@pytest.fixture
def graphs_on_cpu(monkeypatch):
    """CPU solves take the graph path, with ``_EagerGraph`` for graphs."""
    _EagerGraph.made = []
    monkeypatch.setattr(gn_ik, "_graph_device", lambda t: True)
    monkeypatch.setattr(gn_ik, "_LMGraph", _EagerGraph)
    return _EagerGraph.made


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as z:
        return dict(z)


def _solver(dtype=torch.float64, maxiter=6, rule="nielsen"):
    b = bridge.load_bundle()
    fm = bridge.fit_model_from_arrays(b, "cpu", dtype)
    lb, ub = (torch.as_tensor(b[k]).to(dtype) for k in ("lb", "ub"))
    return gn_ik.GNIK(fm.topo, fm.site_idxs, "cpu", maxiter=maxiter, damping_rule=rule), fm.params, lb, ub


def _problem(golden, dtype=torch.float64, frames=6, seed=0):
    """kp_data and q0 of ``frames`` frames: the golden's, shifted by ``seed``."""
    rng = np.random.default_rng(seed)
    kp = np.resize(golden["kp"], (frames, M)) + (rng.normal(0, 1e-3, (frames, M)) if seed else 0)
    q0 = np.resize(golden["q0"], (frames, NQ)) + (rng.normal(0, 0.05, (frames, NQ)) if seed else 0)
    return torch.as_tensor(kp).to(dtype), torch.as_tensor(q0).to(dtype)


def _batch(g, params, kp, q0, lb, ub):
    return g.solve_batch(params, kp, torch.ones(NQ, dtype=torch.bool), torch.ones(M), q0, lb, ub)


def _same(a, b):
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


# ------------------------------------------------------------ the golden


@pytest.mark.parametrize("case,dtype,rule,mask,how", [
    ("f64_nielsen_shared_batch", torch.float64, "nielsen", "shared", "batch"),
    ("f32_nielsen_shared_batch", torch.float32, "nielsen", "shared", "batch"),
    ("f64_fixed_per_item_batch", torch.float64, "fixed", "per_item", "batch"),
    ("f64_fixed_shared_solve", torch.float64, "fixed", "shared", "solve"),
    ("f32_fixed_shared_solve", torch.float32, "fixed", "shared", "solve"),
])
def test_flat_lm_on_the_cpu_bitwise_as_before(golden, case, dtype, rule, mask, how):
    """The eager loop, behind the cache, gives what the flat LM gave before
    there was one (both damping rules, shared and per-item masks, the
    batched ``solve_batch`` and the single-frame ``solve``)."""
    g, params, lb, ub = _solver(dtype, rule=rule)
    qs = torch.ones(NQ, dtype=torch.bool) if mask == "shared" else torch.as_tensor(golden["per_item"])
    args = (params, torch.as_tensor(golden["kp"]).to(dtype), qs, torch.ones(M),
            torch.as_tensor(golden["q0"]).to(dtype), lb, ub)
    res = g.solve_batch(*args) if how == "batch" else g.solve(*args)
    for f, v in res._asdict().items():
        want = golden[f"{case}.{f}"]
        assert v.dtype == torch.from_numpy(want).dtype, f
        assert np.array_equal(v.numpy(), want), f
    assert not g._graphs, "a CPU solve keeps nothing"


# ----------------------------------------------------- sights and spans


def test_first_sight_eager_second_captures_later_replay(graphs_on_cpu, golden, tmp_path):
    g, params, lb, ub = _solver()
    eager, p_e, _, _ = _solver()
    kp, q0 = _problem(golden)
    with profiling.device_trace(str(tmp_path)):
        outs = [_batch(g, params, kp, q0, lb, ub) for _ in range(4)]
    assert len(graphs_on_cpu) == 1 and graphs_on_cpu[0].replays == 3
    (key,) = g._graphs
    assert g._graphs[key] is graphs_on_cpu[0]
    want = _batch(eager, p_e, kp, q0, lb, ub)
    for out in outs:
        _same(out, want)
    with open(next(tmp_path.glob("*.pt.trace.json"))) as fh:
        events = [e for e in json.load(fh)["traceEvents"] if e.get("cat") == "user_annotation"]
    spans = {n: [(e["ts"], e["ts"] + e["dur"]) for e in events if e["name"] == n]
             for n in ("lm.solve", "lm.capture", "lm.replay")}
    assert len(spans["lm.solve"]) == 4
    assert len(spans["lm.capture"]) == 1 and len(spans["lm.replay"]) == 3
    for s, e in spans["lm.capture"] + spans["lm.replay"]:
        assert any(a <= s and e <= b for a, b in spans["lm.solve"])


def test_replay_reads_new_inputs(graphs_on_cpu, golden):
    """The stale-input guard: a replay after the m-phase moved the sites,
    with new keypoints and a new start, gives the eager solve of those."""
    g, params, lb, ub = _solver()
    eager, p_e, _, _ = _solver()
    kp, q0 = _problem(golden)
    for _ in range(2):
        _batch(g, params, kp, q0, lb, ub)
    kp2, q02 = _problem(golden, seed=3)
    sites = torch.as_tensor(np.asarray(g.site_idxs, np.int64))
    moved = params.set_site_pos(params.site_pos[sites] + 2e-3, sites)
    got = _batch(g, moved, kp2, q02, lb, ub)
    assert len(graphs_on_cpu) == 1 and graphs_on_cpu[0].replays == 2
    _same(got, _batch(eager, p_e.set_site_pos(p_e.site_pos[sites] + 2e-3, sites), kp2, q02, lb, ub))
    with pytest.raises(AssertionError):  # the first inputs give another answer
        _same(got, _batch(eager, p_e, kp, q0, lb, ub))


def test_single_frame_solve_is_graphed(graphs_on_cpu, golden):
    """``solve`` (damping in A, one frame, q0 of one dim) takes the cache too."""
    g, params, lb, ub = _solver(rule="fixed")
    eager, p_e, _, _ = _solver(rule="fixed")
    kp, q0 = _problem(golden, frames=1)
    args = (torch.ones(NQ, dtype=torch.bool), torch.ones(M), q0[0], lb, ub)
    outs = [g.solve(params, kp[0], *args) for _ in range(3)]
    assert len(graphs_on_cpu) == 1 and graphs_on_cpu[0].replays == 2
    (key,) = g._graphs
    assert key[3:5] == (False, True)  # nielsen off, lambda in A
    want = eager.solve(p_e, kp[0], *args)
    for out in outs:
        _same(out, want)


def test_launch_count_as_eager(graphs_on_cpu, golden, monkeypatch):
    """A capture adds no launches and a replay adds those it captured: with
    every spd_solve counted as a launch, three graphed solves count what
    three eager ones do."""

    def counting(*a):
        spd.KERNEL_LAUNCHES += 1
        return spd.spd_solve_plain(*a)

    monkeypatch.setattr(gn_ik, "spd_solve", counting)
    monkeypatch.setattr(spd, "KERNEL_LAUNCHES", 0)
    g, params, lb, ub = _solver(maxiter=4)
    kp, q0 = _problem(golden)
    counts = []
    for _ in range(3):
        _batch(g, params, kp, q0, lb, ub)
        counts.append(spd.KERNEL_LAUNCHES)
    assert counts == [4, 8, 12]
    assert graphs_on_cpu[0].launches == 4


# -------------------------------------------------------------- the key


def _key_args(golden, frames=6, dtype=torch.float64, per_item=False):
    g, params, lb, ub = _solver(dtype)
    kp, q0 = _problem(golden, dtype, frames)
    qs = torch.ones(frames, NQ) if per_item else torch.ones(NQ)
    return (params, kp, torch.ones(M, dtype=dtype), g._dof_mask(qs, dtype), q0, lb, ub)


BASE = dict(frames=6, dtype=torch.float64, per_item=False, maxiter=14, nielsen=True, lam_in_a=False)


@pytest.mark.parametrize("change", [{"frames": 7}, {"maxiter": 13}, {"nielsen": False}, {"lam_in_a": True},
                                    {"per_item": True}, {"dtype": torch.float32}])
def test_key_tells_apart(graphs_on_cpu, golden, change):
    def key(frames, dtype, per_item, maxiter, nielsen, lam_in_a):
        return gn_ik.GNIK._graph_key(_key_args(golden, frames, dtype, per_item), maxiter, nielsen, lam_in_a, 0)

    base = key(**BASE)
    assert base is not None
    assert key(**dict(BASE, **change)) != base


def test_key_ignores_values(graphs_on_cpu, golden):
    a = _key_args(golden)
    b = list(_key_args(golden))
    b[1], b[4] = b[1] + 1.0, b[4] * 0.5
    b[0] = b[0].set_site_pos(torch.zeros(2, 3, dtype=torch.float64), torch.tensor([0, 1]))
    assert gn_ik.GNIK._graph_key(a, 14, True, False, 0) == gn_ik.GNIK._graph_key(tuple(b), 14, True, False, 0)


# -------------------------------------------------------- what runs eager


def test_no_graph_on_the_cpu(golden):
    assert gn_ik.GNIK._graph_key(_key_args(golden), 14, True, False, 0) is None


def test_no_graph_with_stall_freezing(graphs_on_cpu, golden):
    assert gn_ik.GNIK._graph_key(_key_args(golden), 14, True, False, 3) is None
    g, params, lb, ub = _solver()
    g.stall_iters = 2
    kp, q0 = _problem(golden)
    for _ in range(3):
        _batch(g, params, kp, q0, lb, ub)
    assert not graphs_on_cpu and not g._graphs


def test_no_graph_above_the_bound(graphs_on_cpu, golden, monkeypatch):
    monkeypatch.setattr(gn_ik, "_GRAPH_MAX_FRAMES", 6)
    assert gn_ik.GNIK._graph_key(_key_args(golden, frames=6), 14, True, False, 0) is not None
    assert gn_ik.GNIK._graph_key(_key_args(golden, frames=7), 14, True, False, 0) is None
    g, params, lb, ub = _solver(maxiter=2)
    kp, q0 = _problem(golden, frames=7)
    for _ in range(3):
        _batch(g, params, kp, q0, lb, ub)
    assert not graphs_on_cpu and not g._graphs


def test_no_graph_while_autograd_records(graphs_on_cpu, golden):
    args = list(_key_args(golden))
    args[4] = args[4].clone().requires_grad_(True)
    assert gn_ik.GNIK._graph_key(tuple(args), 14, True, False, 0) is None
    with torch.no_grad():
        assert gn_ik.GNIK._graph_key(tuple(args), 14, True, False, 0) is not None


# ------------------------------------------------------------ the bound


def test_least_recently_used_dropped(graphs_on_cpu, golden):
    """Nine shapes through a cache of eight: the least recently used goes,
    not the oldest-made once it was used again."""
    g, params, lb, ub = _solver(maxiter=1)
    problems = {f: _problem(golden, frames=f) for f in range(1, 10)}

    def frames_kept():
        return [k[5][10][0][0] for k in g._graphs]  # q0's F

    for f in range(1, 9):
        _batch(g, params, *problems[f], lb, ub)
    for _ in range(2):  # frames 1: captured, replayed, now the most recent
        _batch(g, params, *problems[1], lb, ub)
    assert frames_kept() == [2, 3, 4, 5, 6, 7, 8, 1]
    _batch(g, params, *problems[9], lb, ub)
    assert frames_kept() == [3, 4, 5, 6, 7, 8, 1, 9]
    assert len(g._graphs) == gn_ik._GRAPH_CACHE_SIZE == 8
    assert isinstance(g._graphs[next(k for k in g._graphs if k[5][10][0][0] == 1)], _EagerGraph)
