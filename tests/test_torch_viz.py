"""The port's renderer (``viz.py``) against the JAX package's, on synth.

The render model (keypoint sites, "_new" offset sites, error tendons) is the
JAX one's under the same ``np.random.seed``, exactly; the same ValueErrors
are raised; the video test renders with EGL, and skips without it as
tests/test_viz.py does.
"""

import numpy as np
import pytest

from _torch_common import REPO
from stac_mjx_tpu import viz as jax_viz
from stac_mjx_tpu.config import compose_config as jax_compose_config
from stac_mjx_tpu.stac import Stac as JaxStac
from stac_mjx_tpu_torch import bridge, viz
from stac_mjx_tpu_torch.stac import Stac
from test_viz import _egl_available


@pytest.fixture(scope="module")
def stacs():
    cfg = jax_compose_config(REPO / "configs", overrides=["stac=synth", "model=synth_data"])
    js = JaxStac(REPO / cfg.model.MJCF_PATH, cfg, list(cfg.model.KP_NAMES))
    ts = Stac(bridge.load_bundle(bridge.bundle_path("synth_data")), {"n_frames_per_clip": 1}, device="cpu")
    return js, ts


def _render_model(build, stac, offsets, show_marker_error, **kw):
    np.random.seed(4)
    m, idxs = build(stac, offsets, show_marker_error, height=300, width=2000, **kw)
    sites = [(m.site(i).name, m.site_bodyid[i], m.site_group[i]) for i in range(m.nsite)]
    tendons = [(m.tendon(i).name, m.tendon_adr[i], m.tendon_num[i]) for i in range(m.ntendon)]
    return m, idxs, sites, tendons


@pytest.mark.parametrize("show_marker_error", [False, True])
def test_render_model_matches_jax(stacs, show_marker_error):
    js, ts = stacs
    offsets = np.asarray(ts._offsets) + 0.002
    mj, idx_j, sites_j, tendons_j = _render_model(jax_viz.build_render_model, js, offsets, show_marker_error)
    mt, idx_t, sites_t, tendons_t = _render_model(viz.build_render_model, ts, offsets, show_marker_error,
                                                  base_path=REPO)
    assert idx_t == idx_j and sites_t == sites_j and tendons_t == tendons_j
    assert len(tendons_t) == (1 if show_marker_error else 0)
    np.testing.assert_array_equal(mt.site_pos, mj.site_pos)
    np.testing.assert_array_equal(mt.site_size, mj.site_size)
    np.testing.assert_array_equal(mt.site_rgba, mj.site_rgba)
    np.testing.assert_array_equal(mt.wrap_objid, mj.wrap_objid)
    assert (mt.vis.global_.offwidth, mt.vis.global_.offheight) == (mj.vis.global_.offwidth, mj.vis.global_.offheight)


# (qposes frames, kp_data frames, n_frames, start_frame, message): the JAX tests' two cases.
BAD = {"length_mismatch": (2, 3, 1, 0, "not equal"), "frame_range": (3, 3, 3, 1, "start_frame")}


@pytest.mark.parametrize("case", list(BAD))
def test_render_stac_raises_as_jax(stacs, case, tmp_path):
    js, ts = stacs
    n_q, n_kp, n_frames, start, match = BAD[case]
    errors = []
    for render, stac in ((jax_viz.render_stac, js), (viz.render_stac, ts)):
        with pytest.raises(ValueError, match=match) as e:
            render(stac, np.zeros((n_q, stac.topo.nq)), np.zeros((n_kp, 3)), np.asarray(ts._offsets), n_frames,
                   tmp_path / "x.mp4", start_frame=start)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_render_writes_video_as_jax(stacs, tmp_path):
    if not _egl_available():
        pytest.skip("no EGL device available")
    js, ts = stacs
    qposes = np.tile(ts.params.qpos0.numpy(), (3, 1))
    kp_data = np.zeros((3, 3), dtype=np.float32)
    frames = {}
    for what, render in (("jax", lambda **kw: jax_viz.render_stac(js, **kw)), ("port", ts.render)):
        np.random.seed(2)
        frames[what] = render(qposes=qposes, kp_data=kp_data, offsets=np.asarray(ts._offsets), n_frames=2,
                              save_path=tmp_path / f"{what}.mp4", camera=0, height=240, width=320,
                              show_marker_error=True)
    assert len(frames["port"]) == 2 and frames["port"][0].shape == (240, 320, 3)
    np.testing.assert_array_equal(np.stack(frames["port"]), np.stack(frames["jax"]))
    assert (tmp_path / "port.mp4").stat().st_size > 0


def test_viz_stac_renders_an_artifact_as_jax(stacs, tmp_path):
    """viz_stac of an h5 artifact written by the port: its config names the
    model, whose MJCF resolves under base_path; frames equal the JAX viz_stac's."""
    if not _egl_available():
        pytest.skip("no EGL device available")
    from stac_mjx_tpu_torch import io, viz_stac
    from stac_mjx_tpu_torch.config import compose_config

    _, ts = stacs
    cfg = compose_config(REPO / "configs", overrides=["stac=synth", "model=synth_data"])
    q = np.tile(ts.params.qpos0.numpy(), (3, 1))
    q[:, 0] += np.array([0.0, 0.01, 0.02])
    data = ts._package_data(q, None, None, None, np.zeros((3, 3), np.float32))
    io.save_data_to_h5(config=cfg, file_path=tmp_path / "fit.h5", **data.as_dict())
    frames = {}
    for what, fn in (("jax", jax_viz.viz_stac), ("port", viz_stac)):
        np.random.seed(5)
        got_cfg, frames[what] = fn(tmp_path / "fit.h5", n_frames=3, save_path=tmp_path / f"{what}.mp4",
                                   height=120, width=160, base_path=REPO)
        assert got_cfg.model.MJCF_PATH == cfg.model.MJCF_PATH
    np.testing.assert_array_equal(np.stack(frames["port"]), np.stack(frames["jax"]))
    assert not np.array_equal(frames["port"][0], frames["port"][2])  # the root moved
