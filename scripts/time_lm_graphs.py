"""Eager against CUDA-graph-replayed flat LM solves on the card, by batch size.

For each frame count F, one first-party GNIK (float32, 14 iterations; the
single-frame ``solve`` with damping in A at F = 1, else ``solve_batch``
with damping per frame into K1) solves one problem in turns: with every
solve eager (``gn_ik._GRAPH_MAX_FRAMES`` 0) and with the solve captured
once and replayed (the bound raised to F). Each solve's wall is taken
between two ``torch.cuda.synchronize`` calls; the line gives the medians,
their ratio, the capture's wall, the memory the graph's pool holds, and
whether every replayed result equals the eager one bitwise. The crossover,
where the card's own time per iteration covers the host's dispatch, sets
``gn_ik._GRAPH_MAX_FRAMES``.

    python3 scripts/time_lm_graphs.py [--frames 1 250 720 1000 2048 4096 8192 16384 23040] [--rounds 5]

Needs a card. Prints one JSON line per F.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from stac_mjx_tpu_torch import bridge  # noqa: E402
from stac_mjx_tpu_torch.ops import gn_ik  # noqa: E402


def _problem(device, frames: int, seed: int = 0):
    b = bridge.load_bundle()
    fm = bridge.fit_model_from_arrays(b, device, torch.float32)
    g = gn_ik.GNIK(fm.topo, fm.site_idxs, device, maxiter=14)
    rng = np.random.default_rng(seed)
    q_true = np.tile(b["qpos0"], (frames, 1)) + rng.normal(0, 0.3, (frames, 44))
    q0 = q_true + rng.normal(0, 0.15, (frames, 44))

    def as_t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    kp = g.fk(fm.params, as_t(q_true)).site_xpos[:, g._site_idxs].reshape(frames, -1)
    qs, kps = torch.ones(44, dtype=torch.bool, device=device), torch.ones(69, device=device)
    lb, ub = as_t(b["lb"]), as_t(b["ub"])
    q0 = as_t(q0)
    if frames == 1:
        return g, lambda: g.solve(fm.params, kp[0], qs, kps, q0[0], lb, ub)
    return g, lambda: g.solve_batch(fm.params, kp, qs, kps, q0, lb, ub)


def _timed(solve):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = solve()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def sweep_one(device, frames: int, rounds: int, per_round: int = 3) -> dict:
    g, solve = _problem(device, frames)
    gn_ik._GRAPH_MAX_FRAMES = 0
    _timed(solve)  # warm-up: kernels loaded, allocator primed
    gn_ik._GRAPH_MAX_FRAMES = frames
    _timed(solve)  # first sight: eager
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    capture_s, _ = _timed(solve)  # second sight: capture, then replay
    pool = torch.cuda.memory_reserved(device) - reserved
    eager_s, graph_s, same = [], [], True
    for _ in range(rounds):
        gn_ik._GRAPH_MAX_FRAMES = 0
        runs = [_timed(solve) for _ in range(per_round)]
        eager_s += [t for t, _ in runs]
        want = runs[-1][1]
        gn_ik._GRAPH_MAX_FRAMES = frames
        runs = [_timed(solve) for _ in range(per_round)]
        graph_s += [t for t, _ in runs]
        same &= all(torch.equal(getattr(out, f), getattr(want, f)) for _, out in runs for f in want._fields)
    graphs = sum(isinstance(v, gn_ik._LMGraph) for v in g._graphs.values())
    e, r = statistics.median(eager_s), statistics.median(graph_s)
    return {"frames": frames, "eager_ms": e * 1e3, "replay_ms": r * 1e3, "eager_over_replay": e / r,
            "eager_ms_per_iter": e * 1e3 / 14, "replay_ms_per_iter": r * 1e3 / 14,
            "capture_and_first_replay_ms": capture_s * 1e3, "graph_pool_mb": pool / 2**20,
            "graphs": graphs, "bitwise_equal": bool(same), "solves_each": len(eager_s)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, nargs="+", default=[1, 250, 720, 1000, 2048, 4096, 8192, 16384, 23040])
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    device = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()
    bound = gn_ik._GRAPH_MAX_FRAMES
    try:
        for frames in args.frames:
            line = dict(sweep_one(device, frames, args.rounds), card=card[0] if card else None)
            print(json.dumps(line), flush=True)
    finally:
        gn_ik._GRAPH_MAX_FRAMES = bound


if __name__ == "__main__":
    main()
