#!/usr/bin/env python3
"""Which torch.distributed collectives take CUDA tensors, on one card.

    python3 scripts/probe_collectives.py

Starts two gloo ranks on cuda:0 (how two ranks share one card: NCCL refuses
that), then one NCCL rank, each a process of this script, and has each try
all_reduce, all_gather, all_gather_into_tensor, broadcast and barrier on
CUDA tensors. Prints each rank's results, with the values of an all-reduce
and an all-gather, and the wall time of each group from start to exit.
"""

from __future__ import annotations

import socket
import subprocess
import sys
import time


def rank(backend: str, world: int, rank_: int, port: int) -> None:
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", world_size=world, rank=rank_,
                            device_id=dev if backend == "nccl" else None)
    ops = {
        "all_reduce": lambda: dist.all_reduce(torch.full((5,), float(rank_ + 1), device=dev)),
        "all_gather": lambda: dist.all_gather([torch.empty(3, device=dev) for _ in range(world)],
                                              torch.full((3,), float(rank_), device=dev)),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(3 * world, device=dev), torch.full((3,), float(rank_), device=dev)),
        "broadcast": lambda: dist.broadcast(torch.zeros(3, device=dev), 0),
        "barrier": lambda: dist.barrier(),
    }
    res = {}
    for name, op in ops.items():
        try:
            op()
            torch.cuda.synchronize()
            res[name] = "ok"
        except (RuntimeError, ValueError) as e:
            res[name] = f"{type(e).__name__}: {str(e)[:200]}"
    x = torch.full((4,), float(rank_ + 1), device=dev)
    dist.all_reduce(x)
    out = [torch.empty(2, device=dev) for _ in range(world)]
    dist.all_gather(out, torch.full((2,), float(rank_), device=dev))
    res["all_reduce value"], res["all_gather value"] = x.tolist(), [o.tolist() for o in out]
    print(f"{backend} rank {rank_} of {world}: {res}", flush=True)
    dist.destroy_process_group()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_collectives: needs a CUDA device", file=sys.stderr)
        return 1
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}", flush=True)
    rc = 0
    for backend, world in (("gloo", 2), ("nccl", 1)):
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, __file__, backend, str(world), str(r), str(port)])
                 for r in range(world)]
        for p in procs:
            try:
                p.wait(timeout=120)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                    q.wait()
        codes = [p.returncode for p in procs]
        rc = rc or int(any(codes))
        print(f"{backend}, {world} rank(s): exit codes {codes}, {time.perf_counter() - t0:.1f} s from start to exit",
              flush=True)
    return rc


if __name__ == "__main__":
    if len(sys.argv) == 5:
        rank(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))
        sys.exit(0)
    sys.exit(main())
