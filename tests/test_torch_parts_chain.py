"""The port's lockstep part chain (``part_opt_mode="sequential"``: part p's
solve starts from part p-1's result) against the JAX package, in float64 on
the CPU; the set-up is in ``_torch_parts.py``."""

import pytest

from _torch_parts import check_against_jax, recording


@pytest.fixture(scope="module")
def setup():
    return recording()


@pytest.mark.parametrize("program", ["fit", "ik"])
def test_part_chain_matches_jax_f64(setup, program, monkeypatch):
    check_against_jax(setup, "chain", monkeypatch, fit=program == "fit", ik=program == "ik")
