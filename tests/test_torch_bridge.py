"""What carries the model and the data across to the PyTorch port: the
checked-in bundle, the numpy twin of JAX's permutation, the port's
recording generator, the model's lookup by model config (a bundle, or the
port's builder), and the port's independence from jax, and from mujoco,
yaml, h5py and scipy outside the functions that need them."""

import importlib.util
import json
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import REPO, jax_stac
from stac_mjx_tpu.config import compose_config
from stac_mjx_tpu.models import firstparty as jax_firstparty
from stac_mjx_tpu_torch import bridge
from stac_mjx_tpu_torch.models import firstparty
from stac_mjx_tpu_torch.stac import Stac
from stac_mjx_tpu_torch.utils import prng


@pytest.mark.parametrize("model,stac", [("firstparty", "firstparty"), ("synth_data", "stac_synth_data")])
def test_checked_in_bundle_matches_fresh_export(model, stac):
    """The bundles are regenerable: no silent drift from the JAX package's
    model build (run scripts/export_torch_bundle.py after model edits)."""
    spec = importlib.util.spec_from_file_location("export_torch_bundle", REPO / "scripts" / "export_torch_bundle.py")
    exporter = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(exporter)
    fresh = exporter.bundle_arrays(REPO, model=model, stac=stac)
    checked_in = bridge.load_bundle(bridge.bundle_path(model))
    assert sorted(fresh) == sorted(checked_in)
    for k, v in fresh.items():
        assert checked_in[k].dtype == v.dtype, k
        np.testing.assert_array_equal(checked_in[k], v, err_msg=k)


def test_bundle_matches_the_jax_stac():
    js = jax_stac({})
    b = bridge.load_bundle()
    np.testing.assert_array_equal(b["lb"].astype(np.float32), np.asarray(js._lb))
    np.testing.assert_array_equal(b["ub"].astype(np.float32), np.asarray(js._ub))
    assert list(b["part_names"]) == js._part_names
    np.testing.assert_array_equal(b["trunk_kps"], js._trunk_kps)
    assert int(b["root_kp_idx"]) == js._root_kp_idx
    np.testing.assert_array_equal(b["indiv_parts"], np.stack(js._indiv_parts))
    params = bridge.params_from_arrays(b, "cpu", torch.float32)
    for k in bridge.KINPARAMS_FIELDS:
        np.testing.assert_array_equal(getattr(params, k).numpy(), np.asarray(getattr(js.params, k)), err_msg=k)


@pytest.mark.parametrize("n", [1, 7, 40, 50, 60, 250, 1000])
def test_permutation_is_bit_exact(n):
    want = np.asarray(jax.random.permutation(jax.random.PRNGKey(0), jnp.arange(n), independent=True))
    np.testing.assert_array_equal(prng.permutation(n), want)


def test_make_recording_matches_jax():
    js = jax_stac({})
    kp_j, names_j, off_j, qs_j = jax_firstparty.make_recording(js.cfg, n_frames=120, seed=0, base_path=REPO)
    kp_t, names_t, off_t, qs_t = firstparty.make_recording(bridge.load_bundle(), n_frames=120, seed=0, device="cpu")
    assert names_t == names_j
    # The same numpy RNG sequence over the same joint table: identical
    # ground truth; keypoints from two float32 FKs, atol 1e-5 m.
    np.testing.assert_array_equal(off_t, off_j)
    np.testing.assert_array_equal(qs_t, qs_j)
    assert kp_t.shape == (120, 69) and kp_t.dtype == torch.float32
    np.testing.assert_allclose(kp_t.numpy(), np.asarray(kp_j), rtol=0, atol=1e-5)


_NO_HOST_DEPS = r"""
import sys
for name in ("jax", "jaxlib", "mujoco", "yaml", "h5py", "scipy", "stac_mjx_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
import json
import numpy as np
from stac_mjx_tpu_torch.bridge import load_bundle
from stac_mjx_tpu_torch.models.firstparty import make_recording
from stac_mjx_tpu_torch.stac import Stac
b = load_bundle()
kp, _, _, _ = make_recording(b, n_frames=32, seed=1, device="cpu")
st = Stac(b, dict(pose_mode="lockstep", q_solver="gn-lm", skip_part_opt=True, fk_impl="jump",
                  n_frames_per_clip=16, ik_hier_stride=4, ik_hier_fine_iters=3, ik_return_full=False),
          device="cpu")
out = st.ik_only(kp, st._offsets)
assert out.qpos.shape == (32, 44) and np.isfinite(out.qpos).all()
from stac_mjx_tpu_torch.bridge import bundle_path
d = Stac(b, {"n_frames_per_clip": 1}, model={"N_ITERS": 1, "N_ITER_Q": 3}, device="cpu")  # the defaults
assert np.isfinite(d.fit_offsets(kp[:1]).qpos).all()
s = Stac(load_bundle(bundle_path("synth_data")), {"n_frames_per_clip": 1}, device="cpu")
assert np.isfinite(s.fit_offsets(kp[:1, :3]).qpos).all()

# The driver: it imports, builds its config without PyYAML, and runs the fit
# before the first artifact write needs h5py.
import stac_mjx_tpu_torch.cli
from stac_mjx_tpu_torch import main
from stac_mjx_tpu_torch.config import config_from_dict
cfg = config_from_dict({"model": json.loads(str(b["model_config"])), "stac": dict(
    fit_offsets_path="fit.h5", ik_only_path="ik.h5", data_path="unused.nwb", n_fit_frames=4,
    skip_fit_offsets=False, skip_ik_only=False, continuous=False, infer_qvels=False,
    n_frames_per_clip=16, pose_mode="lockstep", q_solver="gn-lm", skip_part_opt=True, fk_impl="jump")})
cfg.model.N_ITERS = 1
fits = []
fit_offsets = Stac.fit_offsets
Stac.fit_offsets = lambda self, kp: fits.append(1) or fit_offsets(self, kp)
try:
    main.run_stac(cfg, kp, [str(n) for n in b["kp_names"]], base_path=".", device="cpu")
    raise AssertionError("run_stac wrote an artifact without h5py")
except ImportError as e:
    assert "h5py" in str(e) and fits == [1], (e, fits)

# A config that changes only keys that shape no compiled array: the
# checked-in bundle serves it, the Stac derives the rest, no mujoco needed.
from stac_mjx_tpu_torch.bridge import bundle_for_config
cfg.model.ROOT_OPTIMIZATION_KEYPOINT = "TorsoF"
cfg.model.TRUNK_OPTIMIZATION_KEYPOINTS = ["TorsoF", "TorsoM", "PelvisTop", "HipL"]
cfg.model.INDIVIDUAL_PART_OPTIMIZATION = {k: v for k, v in cfg.model.INDIVIDUAL_PART_OPTIMIZATION.items() if k != "tail"}
cfg.model.SITES_TO_REGULARIZE = ["Jaw"]
setup = main.make_stac(cfg, [str(n) for n in b["kp_names"]], device="cpu")
assert bundle_for_config(cfg) is not None and setup._root_kp_idx == 4 and len(setup._indiv_parts) == 5
assert int(setup._trunk_kps.sum()) == 4 and float(setup._is_regularized.sum()) == 3.0
assert np.isfinite(setup.fit_offsets(kp[:4]).qpos).all()
print("NO_HOST_DEPS_OK")
"""


def test_card_path_runs_without_jax_mujoco_yaml_h5py():
    proc = subprocess.run(
        [sys.executable, "-c", _NO_HOST_DEPS], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert "NO_HOST_DEPS_OK" in proc.stdout


@pytest.mark.parametrize(
    "model,stac", [("firstparty", "firstparty"), ("synth_data", "stac_synth_data")]
)
def test_bundle_for_config_finds_the_exported_bundle(model, stac):
    base = [f"model={model}", f"stac={stac}"]
    want = bridge.load_bundle(bridge.bundle_path(model))
    # The model scalars, the loader's keys and another path to the same
    # MJCF file still match.
    for extra in ([], ["model.N_ITERS=2", "model.FTOL=0.01", "model.MOCAP_SCALE_FACTOR=1.0", "model.KP_NAMES=null"],
                  [f"model.MJCF_PATH={REPO / compose_config(REPO / 'configs', overrides=base).model.MJCF_PATH}"]):
        got = bridge.bundle_for_config(compose_config(REPO / "configs", overrides=base + extra))
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


# Configs that no checked-in bundle serves: another uniform scale, or the
# Snout's initial offset moved; and an MJCF that does not exist.
UNSERVED = {"scale": ["model.SCALE_FACTOR=1.0"], "moved_offsets": ["model.KEYPOINT_INITIAL_OFFSETS.Snout=[0.03, 0.0, 0.0]"],
            "missing_mjcf": ["model.MJCF_PATH=models/other.xml"]}
_WITHOUT_MUJOCO = r"""
import sys
sys.modules["mujoco"] = None  # any import of mujoco now raises ImportError
from stac_mjx_tpu_torch.bridge import bundle_for_config
from stac_mjx_tpu_torch.config import compose_config
try:
    bundle_for_config(compose_config("configs", overrides=["model=firstparty", "stac=firstparty"] + sys.argv[1:]))
except ValueError as e:
    print("VALUE_ERROR", e)
"""


@pytest.mark.parametrize(
    "case,mujoco", [("scale", False), ("moved_offsets", False), ("missing_mjcf", True), ("scale", True),
                    ("moved_offsets", True)],
)
def test_bundle_for_config_rejects_another_model(case, mujoco):
    """No checked-in bundle serves these configs. Without mujoco (the card's
    machine) bundle_for_config raises a ValueError that names mujoco and the
    export route, and a missing MJCF raises with mujoco too; with mujoco, the
    others build (``models/builder.bundle_arrays``) and no other model is
    swapped in."""
    overrides = ["model=firstparty", "stac=firstparty"] + UNSERVED[case]
    if not mujoco:
        proc = subprocess.run([sys.executable, "-c", _WITHOUT_MUJOCO, *UNSERVED[case]], cwd=REPO,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        assert re.search(r"VALUE_ERROR no checked-in model bundle matches.*needs mujoco, which does not "
                         r"import here.*export_torch_bundle.py", proc.stdout), proc.stdout
        return
    cfg = compose_config(REPO / "configs", overrides=overrides)
    if case == "missing_mjcf":
        with pytest.raises(ValueError, match="MJCF 'models/other.xml' was not found.*export_torch_bundle.py"):
            bridge.bundle_for_config(cfg, REPO)
        return
    built = bridge.bundle_for_config(cfg, REPO)
    checked_in = bridge.load_bundle()
    assert json.loads(str(built["model_config"])) == cfg.model.to_dict()
    assert sorted(built) == sorted(checked_in)
    differs = [k for k in bridge.KINPARAMS_FIELDS if not np.array_equal(built[k], checked_in[k])]
    assert differs == (["body_pos"] if case == "scale" else ["site_pos"])
    np.testing.assert_array_equal(built["jnt_type"], checked_in["jnt_type"])


_SMALL_CFG = dict(pose_mode="lockstep", q_solver="gn-lm", skip_part_opt=True, fk_impl="jump")


def test_entry_points_default_to_the_card():
    """Without a device, Stac and make_recording run on the card; with no
    card they raise instead of dropping quietly to the CPU."""
    b = bridge.load_bundle()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Stac(b, _SMALL_CFG)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            firstparty.make_recording(b, n_frames=4)
        return
    assert Stac(b, _SMALL_CFG).device.type == "cuda"
    kp, _, _, _ = firstparty.make_recording(b, n_frames=4)
    assert kp.is_cuda


def test_port_never_imports_host_packages():
    """jax, jaxlib and the JAX package: nowhere in the port or in
    chip_smoke.py. The host packages only inside the function bodies of the
    modules that need them, never at module level: mujoco in the model
    builder, the rescale and the renderer; imageio and cv2 in the renderer;
    yaml in config.py and io.py; h5py in io.py and utils/convert.py; scipy in
    io.py and chip_smoke.py (which writes a DANNCE .mat)."""
    never = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|stac_mjx_tpu)\b", re.M)
    port = REPO / "stac_mjx_tpu_torch"
    may_import_in_functions = {
        "mujoco": {port / "models" / "builder.py", port / "models" / "rescale.py", port / "viz.py"},
        "imageio": {port / "viz.py"},
        "cv2": {port / "viz.py"},
        "yaml": {port / "config.py", port / "io.py"},
        "h5py": {port / "io.py", port / "utils" / "convert.py"},
        "scipy": {port / "io.py", REPO / "chip_smoke.py"},
    }
    files = sorted(port.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        text = path.read_text()
        assert not never.search(text), path
        for pkg, allowed in may_import_in_functions.items():
            assert not re.search(rf"^(import|from)\s+{pkg}\b", text, re.M), (path, pkg)
            if path not in allowed:
                assert not re.search(rf"^\s+(import|from)\s+{pkg}\b", text, re.M), (path, pkg)
