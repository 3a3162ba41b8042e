"""The port's first-party tables, MJCF and configs against the JAX package's
and the checked-in files, and its .nwb recording writer against the JAX
package's."""

import subprocess
import sys

import numpy as np
import pytest

from _torch_common import REPO
from stac_mjx_tpu.config import compose_config as jax_compose_config
from stac_mjx_tpu.models import firstparty as jax_firstparty
from stac_mjx_tpu_torch import io
from stac_mjx_tpu_torch.config import compose_config
from stac_mjx_tpu_torch.models import firstparty

ASSETS = {
    "firstparty_xml": "models/firstparty.xml",
    "firstparty_model_yaml": "configs/model/firstparty.yaml",
    "firstparty_stac_yaml": "configs/stac/firstparty.yaml",
}


def test_tables_match_jax():
    assert firstparty.KEYPOINTS == jax_firstparty.KEYPOINTS
    assert list(firstparty.KEYPOINTS) == list(jax_firstparty.KEYPOINTS)  # the order too
    assert firstparty.TRUNK_KEYPOINTS == jax_firstparty.TRUNK_KEYPOINTS
    assert firstparty.ROOT_KEYPOINT == jax_firstparty.ROOT_KEYPOINT
    assert firstparty.PART_GROUPS == jax_firstparty.PART_GROUPS
    assert firstparty._leg("leg_XX", "0.01", -0.02) == jax_firstparty._leg("leg_XX", "0.01", -0.02)


@pytest.mark.parametrize("fn", sorted(ASSETS))
def test_strings_match_jax_and_the_checked_in_file(fn):
    text = getattr(firstparty, fn)()
    assert text == getattr(jax_firstparty, fn)()
    assert text == (REPO / ASSETS[fn]).read_text()


def _asset_dirs(root):
    for rel in ASSETS.values():
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
    return root


def test_write_assets_byte_equal(tmp_path):
    firstparty.write_assets(_asset_dirs(tmp_path))
    for rel in ASSETS.values():
        assert (tmp_path / rel).read_bytes() == (REPO / rel).read_bytes(), rel


def test_module_main_writes_assets(tmp_path):
    """python -m stac_mjx_tpu_torch.models.firstparty <root>."""
    proc = subprocess.run([sys.executable, "-m", "stac_mjx_tpu_torch.models.firstparty", str(_asset_dirs(tmp_path))],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "wrote models/firstparty.xml" in proc.stdout
    for rel in ASSETS.values():
        assert (tmp_path / rel).read_bytes() == (REPO / rel).read_bytes(), rel


def test_write_recording_nwb_matches_jax(tmp_path):
    pytest.importorskip("h5py", reason="writing and reading .nwb files needs h5py")
    overrides = ["model=firstparty", "stac=firstparty"]
    n, seed = 60, 5
    got = firstparty.write_recording_nwb(tmp_path / "port.nwb", compose_config(REPO / "configs", overrides=overrides),
                                         n_frames=n, seed=seed, base_path=REPO, device="cpu")
    want = jax_firstparty.write_recording_nwb(tmp_path / "jax.nwb", jax_compose_config(REPO / "configs", overrides=overrides),
                                              n_frames=n, seed=seed, base_path=REPO)
    (kp, names, off, qs), (kp_j, names_j, off_j, qs_j) = got, want
    assert isinstance(kp, np.ndarray) and kp.shape == (n, 69) and kp.dtype == np.float32
    assert names == names_j
    # The same numpy RNG sequence over the same joint table: identical ground
    # truth; keypoints from two float32 FKs, atol 1e-5 m (test_torch_bridge.py).
    np.testing.assert_array_equal(off, off_j)
    np.testing.assert_array_equal(qs, qs_j)
    np.testing.assert_allclose(kp, np.asarray(kp_j), rtol=0, atol=1e-5)
    loaded = {}
    for tag in ("port", "jax"):
        cfg = compose_config(REPO / "configs", overrides=overrides + [f"stac.data_path={tmp_path / tag}.nwb"])
        loaded[tag] = io.load_data(cfg, base_path=REPO)
    (data, names_p), (data_j, names_jl) = loaded["port"], loaded["jax"]
    assert names_p == names_jl == names
    # mm in the file, meters after load_data: the port's recording round-trips
    # to float32 rounding and stays within the FK tolerance of the JAX file's.
    np.testing.assert_allclose(data, kp, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(data, data_j, rtol=0, atol=1e-5)
