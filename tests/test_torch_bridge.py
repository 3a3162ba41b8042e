"""What carries the model and the data across to the PyTorch port: the
checked-in bundle, the numpy twin of JAX's permutation, the port's
recording generator, and the port's independence from jax, mujoco, yaml
and h5py."""

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
for name in ("jax", "jaxlib", "mujoco", "yaml", "h5py", "stac_mjx_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
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
print("NO_HOST_DEPS_OK")
"""


def test_card_path_runs_without_jax_mujoco_yaml_h5py():
    proc = subprocess.run(
        [sys.executable, "-c", _NO_HOST_DEPS], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert "NO_HOST_DEPS_OK" in proc.stdout


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
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|mujoco|yaml|h5py|stac_mjx_tpu)\b", re.M)
    files = sorted((REPO / "stac_mjx_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        assert not pattern.search(path.read_text()), path
