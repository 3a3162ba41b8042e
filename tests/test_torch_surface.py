"""The port does all that the JAX package does: every public module-level
name of ``stac_mjx_tpu/`` has a counterpart of the same name in the port's
module of the same path, or an entry in ``ELSEWHERE`` (where the
counterpart lives) or ``BY_DESIGN`` (why there is none). And no file of the
port imports JAX or the JAX package. Read with ``ast``: nothing is imported.
"""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX_PKG, PORT_PKG = REPO / "stac_mjx_tpu", REPO / "stac_mjx_tpu_torch"

# (JAX module, name) -> (port module, name there): the counterpart under
# another module or name.
ELSEWHERE = {
    ("models/builder.py", "FitModel"): ("bridge.py", "FitModel"),
    ("ops/gn_ik.py", "quat_exp"): ("ops/quat.py", "quat_exp"),
    # K1's TPU entry points and layout constants: one wrapper, the CUDA
    # kernel's launcher and its plain version.
    ("ops/spd.py", "make_spd_solve"): ("ops/spd.py", "spd_solve"),
    ("ops/spd.py", "make_spd_solve_lanes"): ("ops/spd.py", "spd_solve"),
    ("ops/spd.py", "spd_solve_pallas"): ("ops/spd.py", "spd_solve_cuda"),
    ("ops/spd.py", "spd_solve_pallas_lanes"): ("ops/spd.py", "spd_solve_cuda"),
    ("ops/spd.py", "spd_solve_xla"): ("ops/spd.py", "spd_solve_plain"),
    # The frame-sharded fit: the one fit program, given a process group.
    ("pipeline.py", "fit_offsets_sharded"): ("pipeline.py", "fit_offsets_program"),
}
# (JAX module, name or "*" for the whole module) -> why the port has none.
BY_DESIGN = {
    ("utils/xla.py", "*"): "XLA flags and host-device counts: the port has no XLA (--cpu and gloo ranks cover the rest)",
    ("__init__.py", "enable_xla_flags"): "utils/xla.py's",
    ("utils/__init__.py", "enable_xla_flags"): "utils/xla.py's",
    ("utils/__init__.py", "force_cpu"): "utils/xla.py's",
    ("utils/__init__.py", "host_device_count"): "utils/xla.py's",
    ("ops/spd.py", "LANE"): "the TPU's frames-in-lanes layout: systems stay (F, n, n) on the card",
    ("ops/spd.py", "PANEL"): "the Pallas kernel's column panel: the CUDA kernel keeps a warp's rows in registers",
    ("parallel/mesh.py", "clip_mesh"): "a jax.sharding.Mesh over one process's chips: one process per card here",
    ("pipeline.py", "ik_sequential_segment"): "a TPU program-size bound, while the port's sequential pass is a host "
                                              "loop over frames (stac.seq_segment_frames is accepted without effect)",
}
NO_JAX = ("jax", "jaxlib", "stac_mjx_tpu")


def public_names(path: Path) -> set[str]:
    """Module-level functions, classes and assigned names not starting with
    "_" (plus ``__version__``); in an ``__init__.py``, also what it
    re-exports with ``from ... import``."""
    tree = ast.parse(path.read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names.update(n.id for t in targets for n in ast.walk(t) if isinstance(n, ast.Name))
        elif isinstance(node, ast.ImportFrom) and path.name == "__init__.py":
            names.update(a.asname or a.name for a in node.names)
    return {n for n in names if not n.startswith("_") or n == "__version__"}


JAX_MODULES = sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


def test_the_jax_package_is_found():
    assert len(JAX_MODULES) > 20 and "models/kinematics.py" in JAX_MODULES


@pytest.mark.parametrize("module", JAX_MODULES)
def test_public_names_have_counterparts(module):
    if (module, "*") in BY_DESIGN:
        assert not (PORT_PKG / module).exists(), f"{module} is listed as having no counterpart"
        return
    port = PORT_PKG / module
    assert port.exists(), f"no port of {module}"
    port_names = public_names(port)
    missing = []
    for name in sorted(public_names(JAX_PKG / module)):
        if (module, name) in BY_DESIGN:
            continue
        other_module, other_name = ELSEWHERE.get((module, name), (module, name))
        if other_name not in (port_names if other_module == module else public_names(PORT_PKG / other_module)):
            missing.append(f"{name} (looked for {other_name} in {other_module})")
    assert not missing, f"{module}: no counterpart for {missing}"


def test_tables_name_real_entries():
    """Each table entry names a JAX name that exists and that the port lacks
    under that module: the tables hold no stale rows."""
    for (module, name) in list(ELSEWHERE) + [k for k in BY_DESIGN if k[1] != "*"]:
        assert name in public_names(JAX_PKG / module), (module, name)
        assert name not in public_names(PORT_PKG / module), (module, name)


def _imports(path: Path) -> list[str]:
    """Top-level package of every import in the file, at any depth."""
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out += [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.append(node.module.split(".")[0])
    return out


def test_port_imports_no_jax():
    """Every file of the port, chip_smoke.py and the port's demos."""
    files = sorted(PORT_PKG.rglob("*.py")) + [REPO / "chip_smoke.py"] + sorted((REPO / "demos").glob("torch_*.py"))
    assert len(files) > 30
    bad = {str(p.relative_to(REPO)): m for p in files for m in _imports(p) if m in NO_JAX}
    assert not bad, f"imports of JAX or the JAX package: {bad}"
