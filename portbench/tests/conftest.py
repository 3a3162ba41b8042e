"""Shared helpers of the benchmark's own tests (run with
``python -m pytest portbench/tests``; the repository's ``tests/`` suite
does not collect them). Everything here runs on the CPU at small sizes;
tests that need a card carry the ``cuda`` marker and skip without one."""

from __future__ import annotations

import pytest
import torch

from portbench.harness import spec


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


SMALL = {
    "ik": {"clips": 4, "pool": 1, "trace_calls": 1},
    "fit": {"clips": 1, "clip_frames": 120, "animals": 2, "trace_calls": 1},
}


def small_cell(name: str, **config_model) -> spec.Cell:
    """A cell of BENCHMARK.json with its mix cut to a CPU test's size."""
    cell = spec.Cell(name)
    cell.traffic.update(SMALL.get(cell.traffic["job"], {}))
    if cell.traffic["job"] == "fit":
        cell.config["model"]["N_ITERS"] = 2
    if "pg" in name:
        cell.config["stac"]["n_frames_per_clip"] = 2
        cell.traffic.update(clips=2)
    cell.config["model"].update(config_model)
    return cell
