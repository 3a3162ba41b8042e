"""Times two builds of the batched-Cholesky kernel against each other.

Builds ``stac_mjx_tpu_torch/csrc/spd_chol.cu`` (the tree's kernel) and
another source with the same C interface (``--other``: for example the
parent commit's file, unpacked from ``git archive``), checks both against the
plain version at every shape, then times them in turns (other, tree, tree,
other) at ``chip_smoke.py``'s timed shapes: device time per call
(torch.profiler) and time per call on the stream (CUDA events, taken
before the profiled calls at each shape). Prints one
line per shape and, last, one JSON object with every time.

    python3 scripts/compare_spd_kernels.py --other path/to/spd_chol.cu
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def _load(src: Path, out: Path):
    """nvcc with the port's flags; the library's C solve function."""
    from stac_mjx_tpu_torch.ops import _build

    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    fn = ctypes.CDLL(str(out)).spd_chol_solve_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _solver(fn):
    def solve(A, g, lam):
        F, n = g.shape
        x = torch.empty_like(g)
        rc = fn(A.data_ptr(), g.data_ptr(), lam.data_ptr(), x.data_ptr(), F, n,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: cudaError {rc}")
        return x
    return solve


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="another spd_chol.cu to time against the tree's")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_spd_kernels: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    from _torch_spd_cases import spd_systems
    from chip_smoke import KERNEL_REL_TOL, TIMED, _bound, _device_ms, _stream_ms
    from stac_mjx_tpu_torch.ops import _build, spd

    device = torch.device("cuda:0")
    spd._kernel()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    solvers = {
        "tree": _solver(spd._kernel()[0]),
        "other": _solver(_load(Path(args.other), _build.BUILD_DIR / "spd_chol_other.so")),
    }
    gen = torch.Generator(device=device).manual_seed(1)
    result = {}
    for n, F in TIMED:
        A, g, lam = spd_systems(F, n, gen, device)
        plain = spd.spd_solve_plain(A, g, lam)
        for name, solve in solvers.items():
            err = float((solve(A, g, lam) - plain).abs().max() / plain.abs().max())
            if not err < KERNEL_REL_TOL:
                raise AssertionError(f"{name} disagrees with plain at n={n} F={F}: {err:.3e}")
        t = {name: {"stream": [], "device": []} for name in solvers}
        for how, timer in (("stream", _stream_ms), ("device", _device_ms)):
            for name in ("other", "tree", "tree", "other"):
                fn = lambda: solvers[name](A, g, lam)  # noqa: E731
                for _ in range(3):
                    fn()
                torch.cuda.synchronize()
                t[name][how].append(timer(fn, args.reps))
        bound_ms, _ = _bound(F, n)
        result[f"n={n} F={F}"] = dict(t, bound_ms=bound_ms)
        print(f"n={n} F={F:5d}: device ms other {t['other']['device']} tree {t['tree']['device']}; "
              f"stream ms other {t['other']['stream']} tree {t['tree']['stream']}; bound {bound_ms:.4f} ms")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
