"""The port's CUDA kernels on the card (``cuda`` marker; skipped without a GPU).

Imports neither jax nor the JAX package, so it also runs on the GPU machine,
where jax is absent; ``tests/conftest.py`` imports jax, so skip it there:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_spd_cases import indefinite_batch, spd_systems
from stac_mjx_tpu_torch.ops import spd

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:  # portbench/ sits beside the package
    sys.path.insert(0, str(REPO))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


# Register-layout edges of the kernel (one row block ends at 32 rows, the
# shipped sizes are 6, 37, 73 and 102; 96 is the largest all-register
# instantiation, 97 the first with rows in shared memory) and batch sizes
# that are not a multiple of the systems per CTA; "max" is the kernel's own
# largest n.
EDGE_N = [1, 6, 31, 32, 33, 37, 64, 65, 73, 96, 97, 102, "max"]
EDGE_F = [1, 3, 40, 250, 1250, 10_000, 10_001]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [6, 37, 73])
def test_cuda_kernel_isolates_the_indefinite_system(cuda_device, n):
    """Only the middle system fails (at column n // 2): only its x is non-finite."""
    A, g, mid = indefinite_batch(9, n, seed=n)
    At, gt = (torch.as_tensor(a, dtype=torch.float32, device=cuda_device) for a in (A, g))
    x = spd.spd_solve(At, gt).cpu()
    assert not torch.isfinite(x[mid]).any()
    rest = [f for f in range(9) if f != mid]
    assert torch.isfinite(x[rest]).all()
    A32, g32 = (a[rest].astype(np.float32).astype(np.float64) for a in (A, g))
    want = np.linalg.solve(A32, g32[..., None])[..., 0]
    np.testing.assert_allclose(x[rest].double().numpy(), want, rtol=2e-3, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n", EDGE_N)
def test_cuda_kernel_matches_plain(cuda_device, n):
    """The CUDA kernel against the plain version and a float64 solve on the
    card, with and without lam, and the guards."""
    max_n = spd._kernel()[1]
    n = max_n if n == "max" else n
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    eye64 = torch.eye(n, dtype=torch.float64, device=cuda_device)
    for F in EDGE_F:
        A, g, lam = spd_systems(F, n, gen, cuda_device)
        for l in (None, lam):
            before = spd.KERNEL_LAUNCHES
            x = spd.spd_solve(A, g, l)
            assert spd.KERNEL_LAUNCHES == before + 1
            want = spd.spd_solve_plain(A, g, l)
            torch.cuda.synchronize()
            # float32 Cholesky in another summation order.
            torch.testing.assert_close(x, want, rtol=2e-3, atol=2e-5)
            # The bound chip_smoke.py holds it to: max |x - x64| / max |x64|.
            A64 = A.double() if l is None else A.double() + l.double()[:, None, None] * eye64
            x64 = torch.linalg.solve(A64, g.double())
            assert float((x.double() - x64).abs().max() / x64.abs().max()) < 1e-4, (n, F, l is None)
    bad = torch.diag(torch.tensor([1.0, -1.0], device=cuda_device))[None]
    assert not torch.isfinite(spd.spd_solve(bad, torch.ones(1, 2, device=cuda_device))).any()
    A3, g3 = torch.rand(2, 3, 3, device=cuda_device), torch.rand(2, 3, device=cuda_device)
    with pytest.raises(ValueError):
        spd.spd_solve(A3.double(), g3.double())
    with pytest.raises(ValueError):
        spd.spd_solve(A3.transpose(1, 2), g3)
    with pytest.raises(ValueError):  # past the kernel's largest n
        big = torch.eye(max_n + 1, device=cuda_device)[None].contiguous()
        spd.spd_solve(big, torch.ones(1, max_n + 1, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [37, 44, 69, 73])
def test_row_sum_is_batch_invariant_on_the_card(cuda_device, n):
    """GNIK._row_sum of the first B rows of a 10,000-row batch equals the
    batch's rows bitwise (torch.sum(dim=-1) differed at B = 5 ... 15 for
    n = 69 on an H100: scripts/check_batch_invariance.py)."""
    from stac_mjx_tpu_torch.ops.gn_ik import GNIK

    gen = torch.Generator(device=cuda_device).manual_seed(n)
    x = torch.randn(10_000, n, generator=gen, device=cuda_device)
    for terms in (x * x, x):
        full = GNIK._row_sum(terms)
        for B in tuple(range(1, 17)) + (40, 125, 2000):
            assert torch.equal(GNIK._row_sum(terms[:B]), full[:B]), B


@pytest.mark.cuda
def test_spans_on_the_card_s_timeline(cuda_device, tmp_path):
    """Traced on the card (``device_trace``): every kernel launched inside an
    ``lm.iter`` span starts after the span does, a Stac's second call
    replays its LM solves from graphs inside their ``lm.solve`` spans, and a
    projected-gradient solve under graph replay shows its two captures and
    its replays. A second Stac's first call runs eager after the first's,
    where the profiler, which misses what comes right after its start,
    records its kernels."""
    import glob
    import json

    from stac_mjx_tpu_torch import bridge
    from stac_mjx_tpu_torch.models.firstparty import make_recording
    from stac_mjx_tpu_torch.ops.solver import ProjectedGradient
    from stac_mjx_tpu_torch.stac import Stac
    from stac_mjx_tpu_torch.utils import profiling

    bundle = bridge.load_bundle()
    cfg = {"pose_mode": "lockstep", "q_solver": "gn-lm", "skip_part_opt": True, "fk_impl": "jump",
           "continuous": False, "n_frames_per_clip": 50}
    st = Stac(bundle, cfg, {"N_ITERS": 1}, device=cuda_device)
    kp, _, _, _ = make_recording(bundle, n_frames=200, seed=0, device=cuda_device)
    target = torch.linspace(-1.0, 2.0, 8, device=cuda_device).reshape(4, 2)
    st2 = Stac(bundle, cfg, {"N_ITERS": 1}, device=cuda_device)
    with profiling.device_trace(str(tmp_path)):
        for stac in (st, st2, st):  # the profiler misses the launches right after its start
            stac.ik_only(kp, stac._offsets.copy())
        ProjectedGradient(maxiter=20).run(lambda x: torch.sum((x - target) ** 2, dim=-1),
                                          torch.zeros(4, 2, device=cuda_device),
                                          torch.full((2,), -0.5, device=cuda_device),
                                          torch.full((2,), 1.5, device=cuda_device))
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    events = [e for e in json.load(open(path))["traceEvents"] if e.get("ph") == "X"]
    spans = {}
    for e in events:
        if e.get("cat") == "user_annotation":
            spans.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") == "cuda_runtime" and "correlation" in (e.get("args") or {})}
    iters = sorted(spans["lm.iter"])
    checked = 0
    for e in events:
        if e.get("cat") != "kernel" or e["args"].get("correlation") not in launch:
            continue
        t = launch[e["args"]["correlation"]]
        for s, end in iters:
            if s <= t <= end:
                assert e["ts"] >= s, e["name"]
                checked += 1
                break
    assert checked > 0 and len(iters) > 0
    assert len(spans["pg.capture"]) == 2 and len(spans["pg.replay"]) > 2
    # Each Stac's first call runs its solves eager, st's second captures and replays them.
    assert len(spans["lm.replay"]) == len(spans["lm.capture"]) >= 1
    assert len(spans["lm.solve"]) == 3 * len(spans["lm.replay"])
    for s, end in spans["lm.replay"] + spans["lm.capture"]:
        assert any(a <= s and end <= b for a, b in spans["lm.solve"])


def _lm_problem(device, frames, seed, params=None):
    """A first-party GNIK on the card (float32, nielsen, 14 iterations), its
    params, box, and keypoints of ``frames`` random poses with starts
    perturbed from them; ``params`` moves the sites, as an m-phase does."""
    from stac_mjx_tpu_torch import bridge
    from stac_mjx_tpu_torch.ops.gn_ik import GNIK

    b = bridge.load_bundle()
    fm = bridge.fit_model_from_arrays(b, device, torch.float32)
    g = GNIK(fm.topo, fm.site_idxs, device, maxiter=14)
    params = fm.params if params is None else params
    rng = np.random.default_rng(seed)
    q_true = np.tile(b["qpos0"], (frames, 1)) + rng.normal(0, 0.3, (frames, 44))
    q0 = q_true + rng.normal(0, 0.15, (frames, 44))
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    kp = g.fk(params, as_t(q_true)).site_xpos[:, g._site_idxs].reshape(frames, -1)
    lb, ub = as_t(b["lb"]), as_t(b["ub"])
    return g, params, kp, as_t(q0), lb, ub


@pytest.mark.cuda
@pytest.mark.parametrize("frames", [1, 250, 1000])
def test_lm_graph_replay_bitwise_as_eager(cuda_device, frames, monkeypatch):
    """A GNIK's solves of one shape: the first eager, the second captured
    and replayed, the third replayed, then a fourth with moved sites, new
    keypoints and new starts (a graph that kept its captured inputs would
    answer the old problem): each bitwise the eager solve of its inputs,
    launching K1 as often. At one frame the single-frame ``solve`` (damping
    in A), else ``solve_batch`` (damping per frame into K1)."""
    from stac_mjx_tpu_torch.ops import gn_ik

    g, params, kp, q0, lb, ub = _lm_problem(cuda_device, frames, seed=frames)
    sites = g._site_idxs
    moved = params.set_site_pos(params.site_pos[sites] + 3e-3, sites)
    _, _, kp2, q02, _, _ = _lm_problem(cuda_device, frames, seed=frames + 1, params=moved)
    qs, kps = torch.ones(44, dtype=torch.bool, device=cuda_device), torch.ones(69, device=cuda_device)

    def solve(p, k, q):
        if frames == 1:
            return g.solve(p, k[0], qs, kps, q[0], lb, ub)
        return g.solve_batch(p, k, qs, kps, q, lb, ub)

    problems = [(params, kp, q0)] * 3 + [(moved, kp2, q02)]
    graphed, launches = [], []
    for p, k, q in problems:
        before = spd.KERNEL_LAUNCHES
        graphed.append(solve(p, k, q))
        launches.append(spd.KERNEL_LAUNCHES - before)
    (key,) = g._graphs
    assert isinstance(g._graphs[key], gn_ik._LMGraph) and key[4] == (frames == 1)
    monkeypatch.setattr(gn_ik, "_GRAPH_MAX_FRAMES", 0)
    for (p, k, q), got, n in zip(problems, graphed, launches):
        before = spd.KERNEL_LAUNCHES
        want = solve(p, k, q)
        assert spd.KERNEL_LAUNCHES - before == n == 14
        for f in want._fields:
            assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert not torch.equal(graphed[3].params, graphed[0].params)


@pytest.mark.cuda
def test_no_graph_above_the_bound(cuda_device, monkeypatch):
    from stac_mjx_tpu_torch.ops import gn_ik

    monkeypatch.setattr(gn_ik, "_GRAPH_MAX_FRAMES", 8)
    for frames, graphs in ((9, 0), (8, 1)):
        g, params, kp, q0, lb, ub = _lm_problem(cuda_device, frames, seed=0)
        for _ in range(3):
            g.solve_batch(params, kp, torch.ones(44, device=cuda_device), torch.ones(69, device=cuda_device),
                          q0, lb, ub)
        assert sum(isinstance(v, gn_ik._LMGraph) for v in g._graphs.values()) == graphs, frames


@pytest.mark.cuda
def test_stac_graphed_bitwise_as_eager(cuda_device, monkeypatch):
    """Two calibrations (250 frames, the main path's 112 K1 launches each)
    and two ik calls (1,000 frames in 4 clips, 34 launches) on the
    first-party critter: graphed (the second of each replays every solve)
    bitwise as with every solve eager, at the same launch counts."""
    from stac_mjx_tpu_torch import bridge
    from stac_mjx_tpu_torch.models.firstparty import make_recording
    from stac_mjx_tpu_torch.ops import gn_ik
    from stac_mjx_tpu_torch.stac import Stac

    bundle = bridge.load_bundle()
    cfg = {"pose_mode": "lockstep", "q_solver": "gn-lm", "skip_part_opt": True, "fk_impl": "jump",
           "continuous": False, "ik_hier_stride": 8, "ik_hier_fine_iters": 6, "n_fit_frames": 250,
           "n_frames_per_clip": 250}
    kp, _, _, _ = make_recording(bundle, n_frames=1000, seed=0, device=cuda_device)

    def run():
        st = Stac(bundle, cfg, device=cuda_device)
        outs, launches = [], []
        for _ in range(2):
            for call in (lambda: st.fit_offsets(kp[:250]), lambda: st.ik_only(kp, st._offsets.copy())):
                before = spd.KERNEL_LAUNCHES
                data = call()
                launches.append(spd.KERNEL_LAUNCHES - before)
                outs.append({k: v for k, v in data.as_dict().items() if isinstance(v, np.ndarray)})
        return outs, launches, st

    graphed, n_graphed, st = run()
    assert sum(isinstance(v, gn_ik._LMGraph) for v in st.stac_core_obj.gnik._graphs.values()) >= 2
    monkeypatch.setattr(gn_ik, "_GRAPH_MAX_FRAMES", 0)
    eager, n_eager, st = run()
    assert not st.stac_core_obj.gnik._graphs
    assert n_graphed == n_eager == [112, 34, 112, 34], (n_graphed, n_eager)
    for got, want in zip(graphed, eager):
        assert got.keys() == want.keys()
        for k in want:
            assert np.array_equal(got[k], want[k]), k


# The kernel's outputs at the critter's n (37) and the rodent's (73) on fixed
# systems (``fixed_systems(1250, n, seed=n)``, with lam) as they were before
# the layout for n past 96 was added: the SHA-256 of x's float32 bytes,
# recorded on an NVIDIA H100 80GB HBM3 from the kernel source without that
# layout (sm_90a, the port's nvcc flags). The new layout's kernels sit beside
# these instantiations and leave them as they were.
BEFORE_WIDE = {37: "91049865bf6246fc3c9e954b81a2c3d29c73152976a4ae0010466f4a5ba8d3b3",
               73: "0067819a3cce28e69154ba529241f0807946850202156d1144542c662b0a99d7"}


@pytest.mark.cuda
@pytest.mark.parametrize("n", sorted(BEFORE_WIDE))
def test_cuda_kernel_is_bitwise_as_before_the_wide_layout(cuda_device, n):
    """x bitwise as before, one launch a call, counted under its
    dispatch width (n rounded up to 8)."""
    import hashlib

    from _torch_spd_cases import fixed_systems

    A, g, lam = (t.to(cuda_device) for t in fixed_systems(1250, n, seed=n))
    before, width_before = spd.KERNEL_LAUNCHES, spd.LAUNCHES_BY_WIDTH[spd.dispatch_width(n)]
    x = spd.spd_solve(A, g, lam)
    assert hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest() == BEFORE_WIDE[n]
    assert spd.KERNEL_LAUNCHES == before + 1
    assert spd.LAUNCHES_BY_WIDTH[spd.dispatch_width(n)] == width_before + 1


# The wide layout's sizes: its first n, the tethered fly's, the first of the
# second width, one inside the third, its last; F from one system to the
# fly's ik passes (22,800 coarse, 180,000 fine).
WIDE_N = [97, 102, 104, 113, 128]
WIDE_F = [1, 1000, 22_800, 180_000]


@pytest.mark.cuda
@pytest.mark.parametrize("n", WIDE_N)
def test_cuda_wide_kernel_matches_the_float64_reference(cuda_device, n):
    """The rows past 96 in shared memory: x against the benchmark's float64
    reference (``portbench/reference/spd.py``) on up to 3,000 systems spread
    over the batch, every x finite. Tolerance max |x - x64| / max |x64| <
    1e-4: the float32 Cholesky in another order than float64's (the bound
    the kernel has been held to since its first version, which the LM's
    accept test needs). A rounded to bfloat16 before the float64 solve (a
    stand-in one precision below) misses it by over ten times."""
    from portbench.reference import spd as ref

    gen = torch.Generator(device=cuda_device).manual_seed(n)
    for F in WIDE_F:
        A, g, lam = spd_systems(F, n, gen, cuda_device)
        idx = torch.arange(0, F, max(1, F // 3000), device=cuda_device)
        for l in (lam, None):
            before = spd.LAUNCHES_BY_WIDTH[spd.dispatch_width(n)]
            x = spd.spd_solve(A, g, l)
            assert spd.LAUNCHES_BY_WIDTH[spd.dispatch_width(n)] == before + 1
            x64 = ref.spd_solve(A[idx], g[idx], None if l is None else l[idx])
            assert bool(torch.isfinite(x).all()), (n, F)
            assert ref.relative_error(x[idx], x64) < 1e-4, (n, F, l is None)
            bf16 = ref.spd_solve(A[idx].bfloat16().float(), g[idx], None if l is None else l[idx])
            assert ref.relative_error(bf16, x64) > 1e-3, (n, F)
        del A, g, lam
        torch.cuda.empty_cache()
    A, g, mid = indefinite_batch(9, n, seed=n)
    x = spd.spd_solve(*(torch.as_tensor(a, dtype=torch.float32, device=cuda_device) for a in (A, g))).cpu()
    assert [bool(v) for v in torch.isfinite(x).all(dim=1)] == [f != mid for f in range(9)]


@pytest.mark.cuda
def test_cuda_kernel_refuses_n_129(cuda_device):
    """128 is the largest n: the wrapper raises past it, and the C function
    returns cudaErrorInvalidValue (1) without launching."""
    fn, max_n = spd._kernel()
    assert max_n == 128
    A, g = torch.eye(129, device=cuda_device)[None].contiguous(), torch.ones(1, 129, device=cuda_device)
    before = spd.KERNEL_LAUNCHES
    with pytest.raises(ValueError, match="n <= 128"):
        spd.spd_solve(A, g)
    x = torch.empty_like(g)
    rc = fn(A.data_ptr(), g.data_ptr(), None, x.data_ptr(), 1, 129,
            torch.cuda.current_stream().cuda_stream)
    assert rc == 1 and spd.KERNEL_LAUNCHES == before


@pytest.mark.cuda
def test_fly_ik_on_the_card(cuda_device):
    """The tethered fly's ik on the card with the benchmark cell's settings
    (the fixed-root lockstep LM, hierarchical 8/6, all eager): 20 launches
    of the wide instantiation (14 coarse, 6 fine), no root solve, and poses
    the float64 reference judges within the cell's limits."""
    from portbench.harness import check, spec
    from portbench.jobs import ik_fixed

    cell = spec.Cell("fly-lm.ik-session")
    cell.traffic.update(clips=40, pool=1)
    job = ik_fixed.Job(cell, 7, cuda_device)
    before = spd.LAUNCHES_BY_WIDTH.copy()
    record = job.call(0)
    assert dict(spd.LAUNCHES_BY_WIDTH - before) == {104: 20}
    res = job.evaluate([record])
    ok, checks = check.judge(res["numbers"], cell.limits)
    assert ok, checks
