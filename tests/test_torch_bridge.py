"""What carries the model and the data across to the PyTorch port: the
checked-in bundle, the numpy twin of JAX's permutation, the port's
recording generator, the bundle's lookup by model config, and the port's
independence from jax and mujoco (and from yaml, h5py and scipy outside
the driver's I/O)."""

import importlib.util
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


def test_bundle_for_config_rejects_another_model():
    base = ["model=firstparty", "stac=firstparty"]
    for extra in (["model.KEYPOINT_INITIAL_OFFSETS.Snout=[0.03, 0.0, 0.0]"], ["model.SCALE_FACTOR=1.0"],
                  ["model.MJCF_PATH=models/other.xml"]):
        with pytest.raises(ValueError, match="no model bundle matches.*export_torch_bundle.py"):
            bridge.bundle_for_config(compose_config(REPO / "configs", overrides=base + extra))


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
    """jax, jaxlib, mujoco and the JAX package: nowhere in the port or in
    chip_smoke.py. yaml, h5py and scipy: only inside the function bodies of
    the port's config.py and io.py (and of chip_smoke.py, which writes a
    DANNCE .mat with scipy), never at module level."""
    never = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|mujoco|stac_mjx_tpu)\b", re.M)
    top_level = re.compile(r"^(import|from)\s+(yaml|h5py|scipy)\b", re.M)
    indented = re.compile(r"^\s+(import|from)\s+(yaml|h5py|scipy)\b", re.M)
    port = REPO / "stac_mjx_tpu_torch"
    files = sorted(port.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    may_import_in_functions = {port / "config.py", port / "io.py", REPO / "chip_smoke.py"}
    for path in files:
        text = path.read_text()
        assert not never.search(text), path
        assert not top_level.search(text), path
        if path not in may_import_in_functions:
            assert not indented.search(text), path
