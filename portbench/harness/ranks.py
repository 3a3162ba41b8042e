"""A cell on several cards: one rank process per card, as torchrun starts
them (WORLD_SIZE, RANK, LOCAL_RANK in the environment), joined through a
FileStore in a directory of the run's own (``env.scratch_dir``); NCCL
between the cards, its shared-memory transport off
(``NCCL_SHM_DISABLE=1``: nothing in /dev/shm; NVLink P2P stays).

The parent starts the ranks (``run.py ... --rank-spec <spec.json>``), waits
for every one of them, kills all if one fails or outlives the time limit,
and prints the result line that rank 0 wrote. Every rank runs the same
calls; after each, rank 0 says whether the window goes on (a broadcast).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

RANK_TIMEOUT_S = 330.0


def parent(args, cell, device_fields: dict, start_epoch: float, world: int | None = None,
           extra: dict | None = None) -> int:
    """Starts ``world`` ranks (the cell's chips), waits for them and prints
    rank 0's result. ``extra`` goes into the ranks' spec (the tests' "cpu"
    and smaller "traffic")."""
    from portbench.harness.env import forbidden_modules, scratch_dir

    world = world or cell.chips
    tmp = scratch_dir("portbench-ranks-")
    spec = {"store": str(tmp / "store"), "start_epoch": start_epoch, "out": str(tmp / "rank{rank}.json"),
            **(extra or {})}
    spec_path = tmp / "spec.json"
    spec_path.write_text(json.dumps(spec))
    argv = [sys.executable, str(Path(__file__).resolve().parents[1] / "run.py"), "--workload", args.workload,
            "--seed", str(args.seed), "--seconds", str(args.seconds), "--trace", str(args.trace),
            "--rank-spec", str(spec_path)] + (["--control"] if args.control else [])
    if getattr(args, "fault", None):
        argv += ["--fault", args.fault]
    procs = []
    for rank in range(world):
        env = dict(os.environ, WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE=str(world), NCCL_SHM_DISABLE="1")
        log = open(tmp / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen(argv, env=env, stdout=log, stderr=subprocess.STDOUT), log))
    failed = _join(procs, tmp)
    for rank in range(world):
        text = (tmp / f"rank{rank}.log").read_text()
        tail = text.splitlines()[-15:] if (failed or rank == 0) else []
        for ln in tail:
            print(f"rank {rank}: {ln}", file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    out0 = Path(spec["out"].format(rank=0))
    res = None if failed or not out0.exists() else json.loads(out0.read_text())
    shutil.rmtree(tmp, ignore_errors=True)
    if res is None:
        print(f"portbench: ranks failed: {failed or 'rank 0 wrote no result'}", file=sys.stderr)
        return 1
    result, checks = res["result"], res["checks"]
    result["device"] = dict(device_fields, **result["device"])
    from portbench.run import emit

    emit(result, checks)
    return 0


def _join(procs, tmp: Path) -> list[str]:
    """Waits for every rank; on a failure or the time limit kills the rest.
    Returns what failed."""
    deadline = time.monotonic() + RANK_TIMEOUT_S
    failed = []
    pending = list(enumerate(procs))
    while pending:
        for item in list(pending):
            rank, (proc, log) = item
            rc = proc.poll()
            if rc is None:
                continue
            pending.remove(item)
            log.close()
            if rc != 0:
                failed.append(f"rank {rank} exited with {rc}")
        if failed or time.monotonic() > deadline:
            if not failed:
                failed.append(f"ranks {[r for r, _ in pending]} still running after {RANK_TIMEOUT_S} s")
            for _, (proc, log) in pending:
                proc.kill()
                proc.wait()
                log.close()
            pending = []
        time.sleep(0.05)
    return failed


class Group:
    """The ranks of one cell, as ``run.run_cell`` sees them (cf.
    ``measure.Solo``): rank 0's clock ends the window for all (a broadcast
    after each call), the peak is the fullest card's."""

    def __init__(self, device):
        import torch
        import torch.distributed as dist

        self.dist, self.torch, self.device = dist, torch, device
        self.rank = dist.get_rank()
        self.flag = torch.ones(1, device=device)

    def barrier(self) -> None:
        self.dist.barrier()

    def go_on(self, elapsed: float, seconds: float) -> bool:
        self.flag.fill_(1.0 if elapsed < seconds else 0.0)
        self.dist.broadcast(self.flag, src=0)
        return bool(self.flag.item())

    def peak(self, nbytes: int) -> int:
        t = self.torch.tensor([float(nbytes)], device=self.device)
        self.dist.all_reduce(t, op=self.dist.ReduceOp.MAX)
        return int(t.item())

    def close(self) -> None:
        self.dist.barrier()
        self.dist.destroy_process_group()


def worker(args) -> int:
    """One rank: ``run.run_cell`` on its card within the group (set-up, the
    window or the traced calls, the check on rank 0), then the guard; writes
    its part of the result only if all of that passed."""
    import torch

    from portbench.harness import spec
    from portbench.run import run_as_asked
    from stac_mjx_tpu_torch.parallel.distributed import init_distributed, pod_mesh

    sp = json.loads(Path(args.rank_spec).read_text())
    rank = int(os.environ["RANK"])
    on_card = not sp.get("cpu")  # the CPU (gloo) serves the tests
    device = torch.device("cuda", int(os.environ["LOCAL_RANK"])) if on_card else torch.device("cpu")
    if on_card:
        torch.cuda.set_device(device)
    init_distributed(backend="nccl" if on_card else "gloo", device=device, init_method=f"file://{sp['store']}",
                     world_size=int(os.environ["WORLD_SIZE"]), rank=rank)
    mesh = pod_mesh(device)
    cell = spec.Cell(args.workload)
    for key, value in sp.get("traffic", {}).items():  # smaller mixes for the tests
        cell.traffic[key] = value
    result, checks = run_as_asked(args, cell, device=device, start=sp["start_epoch"], group=Group(device),
                                  mesh=mesh)
    out = {"ok": True} if rank else {"result": result, "checks": checks}
    Path(sp["out"].format(rank=rank)).write_text(json.dumps(out))
    return 0
