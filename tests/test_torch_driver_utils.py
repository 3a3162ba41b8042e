"""The driver's host-side helpers against the JAX package's: the overlap
crossfade and stitch of a continuous ik (bitwise, full and lean payloads)
and asset path resolution."""

import copy

import numpy as np
import pytest

from _torch_common import REPO
from stac_mjx_tpu import io as jio
from stac_mjx_tpu.utils import assets as jassets
from stac_mjx_tpu.utils import batching as jbatching
from stac_mjx_tpu_torch import io
from stac_mjx_tpu_torch.utils import assets, batching

OVERLAP = batching.CONTINUOUS_BATCH_OVERLAP


@pytest.mark.parametrize("shape,axis", [((10, 7), 0), ((10, 4, 3), 0), ((5, 10, 3), 1), ((1, 2), 0)])
def test_crossfade_sigmoid_is_bitwise(shape, axis):
    rng = np.random.default_rng(0)
    for dtype in (np.float32, np.float64):
        a, b = rng.normal(size=shape).astype(dtype), rng.normal(size=shape).astype(dtype)
        want = jbatching.crossfade_sigmoid(a, b, axis=axis)
        got = batching.crossfade_sigmoid(a, b, axis=axis)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _payload(cls, n_clips: int, clip: int, lean: bool, seed: int = 0):
    """A continuous ik's StacData: n_clips windows of clip + overlap frames."""
    rng = np.random.default_rng(seed)
    F = n_clips * (clip + OVERLAP)
    empty = np.zeros((0,), np.float32)
    return cls(
        qpos=rng.normal(size=(F, 44)).astype(np.float32),
        xpos=empty if lean else rng.normal(size=(F, 19, 3)).astype(np.float32),
        xquat=empty if lean else rng.normal(size=(F, 19, 4)).astype(np.float32),
        marker_sites=empty if lean else rng.normal(size=(F, 23, 3)).astype(np.float32),
        offsets=rng.normal(size=(23, 3)).astype(np.float32),
        kp_data=rng.normal(size=(F, 69)).astype(np.float32),
        names_qpos=["q"] * 44,
        names_xpos=["b"] * 19,
        kp_names=["k"] * 23,
    )


@pytest.mark.parametrize("lean", [False, True], ids=["full", "lean"])
@pytest.mark.parametrize("n_clips,clip", [(4, 10), (2, 25), (1, 12), (40, 5)])
def test_handle_edge_effects_is_bitwise(n_clips, clip, lean):
    want = jbatching.handle_edge_effects(_payload(jio.StacData, n_clips, clip, lean), clip)
    got = batching.handle_edge_effects(_payload(io.StacData, n_clips, clip, lean), clip)
    for name in ("qpos", "kp_data", "xpos", "xquat", "marker_sites", "offsets"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    if n_clips >= 2 and clip >= OVERLAP:  # else the stitch's slices overlap or run empty, as in JAX
        assert got.qpos.shape == (n_clips * clip, 44)
    if lean:
        assert got.xpos.size == 0 and got.marker_sites.size == 0


def test_handle_edge_effects_blends_quaternions_linearly():
    """The reference's quirk: quaternion columns blend like any other, so
    crossfaded root quaternions are not unit length."""
    d = _payload(io.StacData, 2, 10, lean=True)
    d.qpos[:, 3:7] = 0.0
    d.qpos[:20, 3] = 1.0  # clip 0: identity
    d.qpos[20:, 4] = 1.0  # clip 1: pi about x
    out = batching.handle_edge_effects(copy.deepcopy(d), 10)
    norms = np.linalg.norm(out.qpos[10:20, 3:7], axis=-1)
    assert norms.min() < 0.75  # the middle of the blend is far from unit length


def test_resolve_asset_matches(tmp_path, monkeypatch):
    (tmp_path / "base").mkdir()
    (tmp_path / "base" / "rec.nwb").write_bytes(b"")
    (tmp_path / "env").mkdir()
    (tmp_path / "env" / "only_here.mat").write_bytes(b"")
    cases = [
        ("models/firstparty.xml", None),  # the repo's own asset
        ("models/firstparty.xml", tmp_path / "base"),  # falls through base to the repo
        ("rec.nwb", tmp_path / "base"),  # base path first
        ("only_here.mat", None),  # through $STAC_TPU_ASSET_PATH
        ("missing.nwb", tmp_path / "base"),  # nothing exists: the first candidate
        ("missing.nwb", None),
        (str(REPO / "configs" / "config.yaml"), tmp_path),  # absolute
    ]
    for env in (None, f"{tmp_path / 'env'}:{tmp_path / 'nowhere'}"):
        if env is None:
            monkeypatch.delenv("STAC_TPU_ASSET_PATH", raising=False)
        else:
            monkeypatch.setenv("STAC_TPU_ASSET_PATH", env)
        for rel, base in cases:
            want = jassets.resolve_asset(rel, base)
            assert assets.resolve_asset(rel, base) == want, (rel, base, env)
        # The JAX package's fixed reference-checkout root, when present, is
        # the one root the port leaves to $STAC_TPU_ASSET_PATH.
        assert assets.asset_roots() == [r for r in jassets.asset_roots() if r != jassets._REFERENCE_ROOT]
    assert assets.resolve_asset("only_here.mat") == tmp_path / "env" / "only_here.mat"
