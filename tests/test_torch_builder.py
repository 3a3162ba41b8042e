"""The port's model builder (``models/builder.py``) against the JAX package's.

- ``bundle_arrays`` equals ``scripts/export_torch_bundle.py::bundle_arrays``
  (the JAX package's model build) bitwise, keys, dtypes and values, for
  firstparty and synth; and the checked-in bundles, which that script wrote
  under mujoco ``bridge.BUNDLE_MUJOCO_VERSION``.
- For firstparty configs that no bundle serves (another SCALE_FACTOR, moved
  initial offsets), the compiled arrays equal the JAX ``Stac``'s
  ``fm.mj_model`` / ``topo`` fields bitwise.
- Meshes whose files are missing are pruned as the JAX builder prunes them.
"""

import importlib.util
import json

import mujoco
import numpy as np
import pytest

from _torch_common import REPO
from stac_mjx_tpu.config import compose_config as jax_compose_config
from stac_mjx_tpu.models.builder import _prune_missing_meshes as jax_prune
from stac_mjx_tpu.stac import Stac as JaxStac
from stac_mjx_tpu_torch import bridge
from stac_mjx_tpu_torch.config import compose_config
from stac_mjx_tpu_torch.models import builder

MODELS = [("firstparty", "firstparty"), ("synth_data", "stac_synth_data")]
# firstparty as no checked-in bundle serves it: each initial offset moved by
# a seeded +-3 mm per coordinate, or another uniform scale.
_rng = np.random.default_rng(7)
MOVED = {k: _rng.uniform(-3e-3, 3e-3, 3) for k in ("Snout", "TorsoM", "PawHL", "TailTip")}
UNSERVED = {
    "scale": ["model.SCALE_FACTOR=1.0"],
    "moved_offsets": [f"model.KEYPOINT_INITIAL_OFFSETS.{k}=[{', '.join(repr(float(x)) for x in v)}]"
                      for k, v in MOVED.items()],
}


def _exporter():
    spec = importlib.util.spec_from_file_location("export_torch_bundle", REPO / "scripts" / "export_torch_bundle.py")
    exporter = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(exporter)
    return exporter


def _assert_same_arrays(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("model,stac", MODELS)
def test_bundle_arrays_equal_the_jax_export(model, stac):
    cfg = compose_config(REPO / "configs", overrides=[f"model={model}", f"stac={stac}"])
    _assert_same_arrays(builder.bundle_arrays(cfg, REPO), _exporter().bundle_arrays(REPO, model=model, stac=stac))


@pytest.mark.parametrize("model,stac", MODELS)
def test_bundle_arrays_equal_the_checked_in_bundle(model, stac):
    """Bitwise under the mujoco release that wrote the bundles, to 1e-12 under another."""
    cfg = compose_config(REPO / "configs", overrides=[f"model={model}", f"stac={stac}"])
    got, want = builder.bundle_arrays(cfg, REPO), bridge.load_bundle(bridge.bundle_path(model))
    if mujoco.__version__ == bridge.BUNDLE_MUJOCO_VERSION:
        _assert_same_arrays(got, want)
    else:
        assert sorted(got) == sorted(want)
        for k in bridge.KINPARAMS_FIELDS + ("lb", "ub", "jnt_range", "timestep"):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12, err_msg=k)


@pytest.mark.parametrize("case", list(UNSERVED))
def test_unserved_config_builds_as_the_jax_stac(case):
    overrides = ["model=firstparty", "stac=firstparty"] + UNSERVED[case]
    cfg = compose_config(REPO / "configs", overrides=overrides)
    jcfg = jax_compose_config(REPO / "configs", overrides=overrides)
    for model, _ in MODELS:  # no checked-in bundle serves it
        recorded = json.loads(str(bridge.load_bundle(bridge.bundle_path(model))["model_config"]))
        assert bridge.model_key_differences(recorded, cfg.model.to_dict())
    js = JaxStac(REPO / jcfg.model.MJCF_PATH, jcfg, list(jcfg.model.KEYPOINT_MODEL_PAIRS.keys()))
    m, topo = js._fit_model.mj_model, js.topo
    got = bridge.bundle_for_config(cfg, REPO)
    for k in bridge.TOPOLOGY_FIELDS:
        v = getattr(topo, k)
        np.testing.assert_array_equal(got[k], np.array(v, dtype=str) if isinstance(v, list) else v, err_msg=k)
    for k in bridge.KINPARAMS_FIELDS:
        assert got[k].dtype == np.float64
        np.testing.assert_array_equal(got[k], getattr(m, k), err_msg=k)
    np.testing.assert_array_equal(got["site_idxs"], js._fit_model.site_idxs)
    np.testing.assert_array_equal(got["is_regularized"], js._fit_model.is_regularized)
    np.testing.assert_array_equal(got["jnt_range"], m.jnt_range)
    assert float(got["timestep"]) == js._fit_model.timestep

    fm, jnt_range = builder.build_fit_model(REPO / cfg.model.MJCF_PATH, cfg.model, device="cpu")
    for k in bridge.KINPARAMS_FIELDS:  # float32 parameters: the JAX Stac's, rounded alike
        np.testing.assert_array_equal(getattr(fm.params, k).numpy(), np.asarray(getattr(js.params, k)), err_msg=k)
    np.testing.assert_array_equal(fm.site_idxs, js._fit_model.site_idxs)
    np.testing.assert_array_equal(jnt_range, m.jnt_range)


MESH_XML = """
<mujoco>
  <asset>
    <mesh name="present" file="present.obj"/>
    <mesh name="absent" file="absent.obj"/>
  </asset>
  <worldbody>
    <body name="root" pos="0 0 0.1">
      <freejoint/>
      <geom name="g_present" type="mesh" mesh="present"/>
      <geom name="g_absent" type="mesh" mesh="absent"/>
      <geom name="g_box" type="box" size=".01 .01 .01"/>
      <body name="child" pos="0.1 0 0">
        <joint name="hinge" type="hinge" axis="0 0 1"/>
        <geom name="g_child_absent" type="mesh" mesh="absent"/>
        <geom name="g_child_sphere" type="sphere" size=".01"/>
      </body>
    </body>
  </worldbody>
</mujoco>
"""
TETRA_OBJ = "v 0 0 0\nv 0.01 0 0\nv 0 0.01 0\nv 0 0 0.01\nf 1 3 2\nf 1 2 4\nf 1 4 3\nf 2 3 4\n"


def test_missing_meshes_are_pruned_as_the_jax_builder_prunes_them(tmp_path):
    (tmp_path / "model.xml").write_text(MESH_XML)
    (tmp_path / "present.obj").write_text(TETRA_OBJ)
    specs = []
    for prune in (builder._prune_missing_meshes, jax_prune):
        spec = mujoco.MjSpec.from_file(str(tmp_path / "model.xml"))
        prune(spec, tmp_path)
        specs.append(spec)
    port, ref = specs
    names = [([m.name for m in s.meshes], [g.name for b in s.bodies for g in b.geoms]) for s in specs]
    assert names[0] == names[1] == (["present"], ["g_present", "g_box", "g_child_sphere"])
    mp, mr = port.compile(), ref.compile()
    assert (mp.nmesh, mp.ngeom) == (mr.nmesh, mr.ngeom) == (1, 3)
    np.testing.assert_array_equal(mp.body_pos, mr.body_pos)
