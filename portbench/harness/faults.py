"""Faults planted under the timed path, for the check's own tests: each must
make ``correct`` come out false. Installed by patching the program's module
attributes (restored on exit); nothing here runs in a measuring run.

- ``unchanged``: every pose solve returns its starting poses;
- ``half``: every pose solve solves the first half of its batch and hands
  back the rest at their starting poses;
- ``altered``: every pose solve moves its first frame's root by
  5 cm before returning it (an answer altered where it is produced);
- ``mphase_unchanged``: the m-phase returns the offsets it was handed;
- ``no_gather``: the results' all-gather is left out: each rank's block
  stands in for every rank's;
- ``no_allreduce``: the m-phase's all-reduce is left out: each rank solves
  for the offsets from its own frames' statistics;
- ``loads_jax``: every pose solve on the last rank (the only one, in one
  process) first puts a module named ``jax`` into ``sys.modules``, as an
  import in the program would; like an import, it stays after the fault is
  removed. The guard has to fail the run.
"""

from __future__ import annotations

import contextlib
import importlib
import sys
import types

import torch

ROOT_SHIFT_M = 0.05


def _half(solve):
    def run(self, params, kp_data, qs_to_opt, kps_to_opt, q0, lb, ub, *a, **kw):
        h = max(1, q0.shape[0] // 2)
        qs = qs_to_opt[:h] if qs_to_opt.ndim == 2 else qs_to_opt
        res = solve(self, params, kp_data[:h], qs, kps_to_opt, q0[:h], lb, ub, *a, **kw)
        return res._replace(params=torch.cat([res.params, q0[h:]], dim=0))
    return run


def _unchanged(solve):
    def run(self, params, kp_data, qs_to_opt, kps_to_opt, q0, lb, ub, *a, **kw):
        res = solve(self, params, kp_data[:1], qs_to_opt[:1] if qs_to_opt.ndim == 2 else qs_to_opt,
                    kps_to_opt, q0[:1], lb, ub, *a, **kw)
        return res._replace(params=q0.clone())
    return run


def _altered(solve):
    def run(self, *a, **kw):
        res = solve(self, *a, **kw)
        q = res.params.clone()
        q[0, 0] += ROOT_SHIFT_M
        return res._replace(params=q)
    return run


def _mphase_unchanged(m_opt):
    def run(p_all, R_all, y, initial_offsets, *a, **kw):
        res = m_opt(p_all, R_all, y, initial_offsets, *a, **kw)
        return res._replace(params=initial_offsets.clone())
    return run


def _no_gather(fetch):
    def run(tree, mesh=None, dim=0):
        if isinstance(tree, dict):
            return {k: run(v, mesh, dim) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(run(v, mesh, dim) for v in tree)
        t = tree.detach()
        size = 1 if mesh is None else mesh.size
        return torch.cat([t] * size, dim=dim).cpu().numpy()
    return run


def _no_allreduce(m_opt):
    def run(*a, group=None, **kw):
        return m_opt(*a, group=None, **kw)
    return run


def _loads_jax(solve):
    def run(*a, **kw):
        d = torch.distributed
        if not d.is_initialized() or d.get_rank() == d.get_world_size() - 1:
            sys.modules.setdefault("jax", types.ModuleType("jax", PLANTED_JAX))
        return solve(*a, **kw)
    return run


PLANTED_JAX = "a stand-in planted by portbench's loads_jax fault"

# fault -> [(module, attribute path, wrapper)]
_SOLVES = ("StacCore.q_opt", "StacCore.q_opt_batch")
FAULTS = {
    "unchanged": [("stac_mjx_tpu_torch.ops.stac_core", p, _unchanged) for p in _SOLVES],
    "half": [("stac_mjx_tpu_torch.ops.stac_core", p, _half) for p in _SOLVES],
    "altered": [("stac_mjx_tpu_torch.ops.stac_core", p, _altered) for p in _SOLVES],
    "mphase_unchanged": [("stac_mjx_tpu_torch.ops.stac_core", "m_opt_closed_form", _mphase_unchanged)],
    "no_gather": [("stac_mjx_tpu_torch.parallel.distributed", "fetch_arrays", _no_gather)],
    "no_allreduce": [("stac_mjx_tpu_torch.ops.stac_core", "m_opt_closed_form", _no_allreduce)],
    "loads_jax": [("stac_mjx_tpu_torch.ops.stac_core", p, _loads_jax) for p in _SOLVES],
}


@contextlib.contextmanager
def planted(name: str):
    undo = []
    try:
        for mod_name, path, wrap in FAULTS[name]:
            owner = importlib.import_module(mod_name)
            *outer, attr = path.split(".")
            for part in outer:
                owner = getattr(owner, part)
            orig = owner.__dict__[attr]
            setattr(owner, attr, wrap(orig))
            undo.append((owner, attr, orig))
        yield
    finally:
        for owner, attr, orig in reversed(undo):
            setattr(owner, attr, orig)
