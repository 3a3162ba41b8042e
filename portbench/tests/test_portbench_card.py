"""On a card: a short run of each one-card cell comes out correct, and its
control does not. Skips without a card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from portbench.harness.env import ROOT


def _run(workload: str, *extra: str) -> dict:
    proc = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"), "--workload", workload,
                           "--seed", "2147483659", "--seconds", "2", "--trace", "0", *extra],
                          capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["critter-lm.ik-session", "critter-lm.fit"])
def test_cell_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    line = _run(workload)
    assert line["correct"] and line["device"]["platform"] == "gpu", line["checks"]
    assert not _run(workload, "--control")["correct"]
