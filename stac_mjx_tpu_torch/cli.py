"""Console entry point (``stac-mjx-tpu-torch``; port of ``stac_mjx_tpu/cli.py``).

The JAX CLI's flags: config directory/name, base path, --print-config, plus
free-form ``group=name`` / ``a.b=value`` overrides forwarded to config
composition. ``--cpu`` runs on the CPU; without it the run needs a CUDA
device and raises when there is none. ``--skip-xla-flags`` is accepted and
does nothing (there are no XLA flags here), so the JAX package's command
lines run unchanged. ``--distributed`` is not ported yet.

    python -m stac_mjx_tpu_torch.cli --config-path configs model=firstparty stac=firstparty
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

log = logging.getLogger(__name__)

_FLAGS = (
    ("--config-path", dict(default="configs", help="config directory")),
    ("--config-name", dict(default="config", help="root config to compose")),
    ("--base-path", dict(default=None, help="root for data/model paths (default: CWD)")),
    ("--print-config", dict(action="store_true", help="dump the composed config as YAML and exit")),
    ("--skip-xla-flags", dict(action="store_true", help="accepted for the JAX CLI's command lines; no effect")),
    ("--cpu", dict(action="store_true", help="run on the CPU (default: the CUDA device)")),
    ("--distributed", dict(action="store_true", help="multi-process run: not ported yet")),
)


def build_parser() -> argparse.ArgumentParser:
    """The argument parser; config overrides are collected as unknowns."""
    parser = argparse.ArgumentParser(
        prog="stac-mjx-tpu-torch",
        description="STAC on a CUDA GPU (PyTorch): register mocap keypoints onto a "
        "body model. Unrecognized KEY=VALUE arguments override config fields.",
    )
    for flag, kw in _FLAGS:
        parser.add_argument(flag, **kw)
    return parser


def parse_args(argv=None):
    """Split argv into known flags and pass-through config overrides."""
    return build_parser().parse_known_args(argv)


def run_pipeline(cfg, base_path: Path, device: str = "cuda"):
    """Load data and execute the pipeline for a composed config."""
    from stac_mjx_tpu_torch.io import load_data
    from stac_mjx_tpu_torch.main import run_stac

    kp_data, kp_names = load_data(cfg, base_path=base_path)
    return run_stac(cfg, kp_data, kp_names, base_path=base_path, device=device)


def main(argv=None) -> int:
    """Entry point: compose config, then run (or just print) it."""
    logging.basicConfig(level=logging.INFO)
    args, overrides = parse_args(argv)
    if args.distributed:
        raise NotImplementedError(
            "--distributed is not ported to the PyTorch package yet "
            "(ROADMAP.md §1, item 6: torch.distributed and the psum'd m-phase)"
        )

    from stac_mjx_tpu_torch.config import compose_config

    cfg = compose_config(config_path=args.config_path, config_name=args.config_name, overrides=overrides)
    if args.print_config:
        print(cfg.to_yaml())
        return 0

    base_path = Path(args.base_path).resolve() if args.base_path else Path.cwd()
    paths = run_pipeline(cfg, base_path=base_path, device="cpu" if args.cpu else "cuda")
    log.info("artifacts: fit=%s ik=%s", *paths)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
