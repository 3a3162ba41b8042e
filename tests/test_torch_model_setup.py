"""The ``Stac``'s model set-up computed by the port (``models/setup.py``)
against the JAX ``Stac``'s: bounds with their quirks (``_align_joint_dims``),
part masks (``part_opt_setup``), the trunk mask, the root keypoint and the
regularisation mask, and the pipeline configuration they resolve to. On
firstparty (as configured and with every set-up-only key changed), on synth,
and on small inline models with a slide root and a fixed root, (0, 0)
ranges, a positive lower bound and a ball range. All comparisons are exact.
"""

import numpy as np
import pytest
import torch

from _torch_common import REPO, assert_same_static_cfg
from stac_mjx_tpu.config import compose_config as jax_compose_config
from stac_mjx_tpu.config import config_from_dict as jax_config_from_dict
from stac_mjx_tpu.stac import Stac as JaxStac
from stac_mjx_tpu.stac import _align_joint_dims
from stac_mjx_tpu_torch import bridge
from stac_mjx_tpu_torch.config import compose_config, config_from_dict
from stac_mjx_tpu_torch.models import builder
from stac_mjx_tpu_torch.models.setup import model_setup
from stac_mjx_tpu_torch.stac import Stac

SLIDE_XML = """
<mujoco>
  <worldbody>
    <body name="cart" pos="0 0 0.1">
      <joint name="rail" type="slide" axis="1 0 0"/>
      <geom type="box" size=".05 .05 .05"/>
      <body name="arm" pos="0 0 0.1">
        <joint name="arm_lift" type="hinge" axis="0 1 0" range="0.3 1.2"/>
        <joint name="arm_spin" type="hinge" axis="0 0 1"/>
        <geom type="capsule" size=".01" fromto="0 0 0 0 0 .2"/>
        <body name="hand" pos="0 0 0.2">
          <joint name="hand_ball" type="ball" range="0 0.5"/>
          <joint name="hand_slide" type="slide" axis="0 0 1" range="-0.1 0.2"/>
          <geom type="sphere" size=".02"/>
        </body>
      </body>
    </body>
  </worldbody>
</mujoco>
"""

FIXED_XML = """
<mujoco>
  <worldbody>
    <body name="torso" pos="0 0 0.2">
      <geom type="box" size=".05 .03 .02"/>
      <body name="neck" pos="0.05 0 0">
        <joint name="neck_yaw" type="hinge" axis="0 0 1"/>
        <geom type="capsule" size=".01" fromto="0 0 0 .04 0 0"/>
        <body name="head" pos="0.04 0 0">
          <joint name="head_pitch" type="hinge" axis="0 1 0" range="-0.5 0.5"/>
          <joint name="head_ball" type="ball"/>
          <geom type="sphere" size=".02"/>
        </body>
      </body>
    </body>
  </worldbody>
</mujoco>
"""

_SCALARS = dict(FTOL=1e-4, ROOT_FTOL=1e-5, LIMB_FTOL=1e-6, N_ITERS=1, N_ITER_Q=20, N_SAMPLE_FRAMES=4,
                M_REG_COEF=1.0, SCALE_FACTOR=1.0, MOCAP_SCALE_FACTOR=1.0, MARKER_SIZE=0.005)
INLINE = {
    "slide_root": (SLIDE_XML, dict(
        _SCALARS,
        KEYPOINT_MODEL_PAIRS={"kp_cart": "cart", "kp_arm": "arm", "kp_hand": "hand"},
        KEYPOINT_INITIAL_OFFSETS={"kp_cart": [0, 0, 0.05], "kp_arm": [0, 0, 0.1], "kp_hand": "0.01 0 0"},
        ROOT_OPTIMIZATION_KEYPOINT="kp_cart",
        TRUNK_OPTIMIZATION_KEYPOINTS=["kp_cart"],
        INDIVIDUAL_PART_OPTIMIZATION={"arm": ["arm_"], "hand": ["hand_", "rail"]},
        SITES_TO_REGULARIZE=["kp_hand"],
    )),
    "fixed_root": (FIXED_XML, dict(
        _SCALARS,
        KEYPOINT_MODEL_PAIRS={"kp_torso": "torso", "kp_neck": "neck", "kp_head": "head"},
        KEYPOINT_INITIAL_OFFSETS={"kp_torso": [0, 0, 0.02], "kp_neck": [0.02, 0, 0], "kp_head": [0.02, 0, 0]},
        TRUNK_OPTIMIZATION_KEYPOINTS=["kp_torso", "kp_neck"],
    )),
}
# firstparty with every set-up-only key changed.
SETUP_ONLY = {
    "ROOT_OPTIMIZATION_KEYPOINT": "TorsoF",
    "TRUNK_OPTIMIZATION_KEYPOINTS": ["TorsoF", "TorsoM", "PelvisTop", "HipL"],
    "INDIVIDUAL_PART_OPTIMIZATION": {"head": ["neck_", "head_", "jaw_"], "leg_FL": ["leg_FL"],
                                     "leg_FR": ["leg_FR"], "leg_HL": ["leg_HL"], "tail": ["tail_"]},
    "SITES_TO_REGULARIZE": ["Jaw", "PawFL"],
}
# firstparty with the optional set-up keys left out: no root solve, no part
# passes, no regularised site (configs/model/celegans.yaml leaves out the root).
DROPPED = ("ROOT_OPTIMIZATION_KEYPOINT", "INDIVIDUAL_PART_OPTIMIZATION", "SITES_TO_REGULARIZE")
STAC = dict(fit_offsets_path="fit.h5", ik_only_path="ik.h5", data_path="unused.nwb", n_fit_frames=4,
            pose_mode="lockstep", q_solver="gn-lm", skip_part_opt=False, fk_impl="jump", n_frames_per_clip=4)


def _configs(case, tmp_path):
    """(port config, JAX config, MJCF path) of a case."""
    if case in INLINE:
        xml, model = INLINE[case]
        path = tmp_path / f"{case}.xml"
        path.write_text(xml)
        data = {"model": dict(model, MJCF_PATH=str(path)), "stac": STAC}
        return config_from_dict(data), jax_config_from_dict(dict(data, model=dict(data["model"]))), path
    name, stac = {"firstparty": ("firstparty", "firstparty"), "firstparty_setup_only": ("firstparty", "firstparty"),
                  "firstparty_keys_dropped": ("firstparty", "firstparty"), "synth": ("synth_data", "stac_synth_data")}[case]
    overrides = [f"model={name}", f"stac={stac}"] + [f"stac.{k}={str(v).lower()}" for k, v in STAC.items()
                                                     if k in ("pose_mode", "q_solver", "fk_impl", "skip_part_opt")]
    cfgs = [fn(REPO / "configs", overrides=overrides) for fn in (compose_config, jax_compose_config)]
    if case == "firstparty_setup_only":
        for cfg in cfgs:
            for k, v in SETUP_ONLY.items():
                setattr(cfg.model, k, v)
    elif case == "firstparty_keys_dropped":
        data = {"model": {k: v for k, v in cfgs[0].model.to_dict().items() if k not in DROPPED},
                "stac": cfgs[0].stac.to_dict()}
        cfgs = [config_from_dict(data), jax_config_from_dict(dict(data, model=dict(data["model"])))]
    return cfgs[0], cfgs[1], REPO / cfgs[0].model.MJCF_PATH


CASES = ["firstparty", "firstparty_setup_only", "firstparty_keys_dropped", "synth", "slide_root", "fixed_root"]


@pytest.mark.parametrize("case", CASES)
def test_model_setup_matches_the_jax_stac(case, tmp_path):
    cfg, jcfg, xml = _configs(case, tmp_path)
    js = JaxStac(xml, jcfg, list(jcfg.model.KEYPOINT_MODEL_PAIRS.keys()))
    fm, jnt_range = builder.build_fit_model(xml, cfg.model, device="cpu")
    got = model_setup(cfg.model, {"jnt_type": fm.topo.jnt_type, "jnt_range": jnt_range,
                                  "jnt_names": fm.topo.jnt_names})
    lb, ub, part_names = _align_joint_dims(js.topo.jnt_type, np.asarray(js._mj_model.jnt_range), js.topo.jnt_names)
    np.testing.assert_array_equal(got["lb"], lb)
    np.testing.assert_array_equal(got["ub"], ub)
    assert got["part_names"] == part_names == js._part_names
    assert got["kp_names"] == js._kp_names
    np.testing.assert_array_equal(got["indiv_parts"], np.array(js._indiv_parts, bool).reshape(-1, js.topo.nq))
    np.testing.assert_array_equal(got["trunk_kps"], js._trunk_kps)
    assert got["root_kp_idx"] == js._root_kp_idx
    np.testing.assert_array_equal(got["is_regularized"], js._fit_model.is_regularized)
    np.testing.assert_array_equal(fm.is_regularized, js._fit_model.is_regularized)
    if case == "slide_root":  # the quirks these models exist for: (0, 0) ranges, lb clamped to <= 0
        assert np.isinf(ub[0]) and lb[1] == 0 and got["root_kp_idx"] == 0
    elif case == "fixed_root":
        assert ub[0] == 2 * np.pi and got["root_kp_idx"] == -1
    elif case == "firstparty_keys_dropped":  # left out, not taken back from the bundle's recorded config
        assert got["root_kp_idx"] == -1 and got["indiv_parts"].shape[0] == 0 and not got["is_regularized"].any()

    # The port's Stac: its model from bridge.bundle_for_config (a checked-in
    # bundle, or the builder where none serves), its set-up from the config.
    st = Stac(bridge.bundle_for_config(cfg, tmp_path), cfg.stac.to_dict(), model_config=cfg.model.to_dict(),
              device="cpu", dtype=torch.float64)
    np.testing.assert_array_equal(st._lb.numpy(), lb)
    np.testing.assert_array_equal(st._ub.numpy(), ub)
    np.testing.assert_array_equal(st._is_regularized.numpy(), js._fit_model.is_regularized)
    assert (st._freejoint, st._slidejoint, st._fixed) == (js._freejoint, js._slidejoint, js._fixed)
    assert_same_static_cfg(st._static_cfg, js._static_cfg)
    if case == "firstparty_keys_dropped":
        assert st._root_kp_idx == -1 and st._indiv_parts == [] and not st._is_regularized.any()
        assert not st._static_cfg.do_root_opt and st._static_cfg.indiv_parts == ()


def test_model_overrides_take_model_scalars_only():
    """``model`` lays model scalars over the config; a whole model config goes
    to ``model_config``, so its left-out keys are not filled from the bundle's."""
    b = bridge.load_bundle()
    st = Stac(b, STAC, model={"N_ITERS": 3}, device="cpu")
    assert st._static_cfg.n_iters == 3 and st._root_kp_idx >= 0
    with pytest.raises(ValueError, match="ROOT_OPTIMIZATION_KEYPOINT.*model_config"):
        Stac(b, STAC, model={"N_ITERS": 3, "ROOT_OPTIMIZATION_KEYPOINT": "TorsoF"}, device="cpu")


@pytest.mark.parametrize("model", ["firstparty", "synth_data"])
def test_setup_of_the_recorded_config_equals_the_bundles_arrays(model):
    """The set-up the Stac computes from a bundle's recorded model config is
    what the bundle stores under the same keys, bitwise."""
    import json

    b = bridge.load_bundle(bridge.bundle_path(model))
    got = model_setup(json.loads(str(b["model_config"])), b)
    for k, v in got.items():
        want = b[k]
        v = np.array(v, dtype=want.dtype) if want.dtype.kind == "U" else np.asarray(v)
        assert v.dtype == want.dtype, k
        np.testing.assert_array_equal(v, want, err_msg=k)
