"""The port's demos (``demos/torch_*.py``) against the JAX package's
(``demos/synth_data_demo.py``, ``demos/graph_error_demo.py``) on the same
inputs, on the CPU."""

import importlib.util
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_common import REPO
from stac_mjx_tpu_torch import io, main
from stac_mjx_tpu_torch.config import compose_config
from stac_mjx_tpu_torch.models import firstparty

N_FRAMES, CLIP = 24, 12


def _demo(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "demos" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_synth_demo_matches_jax(capsys, monkeypatch):
    """The same fit of the same synthesized keypoint: the port's report lines
    equal the JAX demo's, its fitted qpos and markers equal the JAX fit's to
    float32 FK rounding, and the port's fit recovers the trajectory."""
    jax_demo, demo = _demo("synth_data_demo"), _demo("torch_synth_data_demo")
    jax_fits, jax_fit_offsets = [], jax_demo.Stac.fit_offsets
    monkeypatch.setattr(jax_demo.Stac, "fit_offsets",
                        lambda self, kp: jax_fits.append(jax_fit_offsets(self, kp)) or jax_fits[-1])
    assert jax_demo.main() == 0
    want = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith(("mean marker", "max recovered"))]
    out = demo.run("cpu")
    capsys.readouterr()
    demo.report(out)
    got = capsys.readouterr().out.splitlines()
    assert len(want) == 2 and got == want
    fit, (jax_fit,) = out["fit"], jax_fits
    assert fit.qpos.shape == (demo.N_FRAMES, 7) and np.isfinite(fit.qpos).all()
    # Both packages' float32 FK and fit of the same keypoint: positions of
    # O(0.3 m) agree to float32 rounding, well within 1e-5.
    np.testing.assert_allclose(fit.qpos, np.asarray(jax_fit.qpos), rtol=0, atol=1e-5)
    np.testing.assert_allclose(fit.marker_sites, np.asarray(jax_fit.marker_sites), rtol=0, atol=1e-5)
    np.testing.assert_allclose(out["kp"], np.asarray(jax_fit.kp_data).reshape(demo.N_FRAMES, -1), rtol=0, atol=1e-5)
    assert out["residual"] < 1e-6 and out["drift"] < 1e-6
    assert out["kp"].shape == (demo.N_FRAMES, 3) and out["qs"].dtype == np.float32


def test_demos_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the card tests run the demos there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _demo("torch_synth_data_demo").run()


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """A firstparty run_stac of the port on the CPU: fit 12 frames, ik 24."""
    pytest.importorskip("h5py", reason="STAC artifacts are h5 files")
    root = tmp_path_factory.mktemp("demo")
    overrides = ["model=firstparty", "stac=firstparty", "stac.data_path=rec.nwb", "stac.pose_mode=lockstep",
                 "stac.q_solver=gn-lm", "stac.skip_part_opt=true", "stac.fk_impl=jump", f"stac.n_fit_frames={CLIP}",
                 f"stac.n_frames_per_clip={CLIP}", "model.N_ITERS=1"]
    cfg = compose_config(REPO / "configs", overrides=overrides)
    firstparty.write_recording_nwb(root / "rec.nwb", cfg, n_frames=N_FRAMES, seed=6, base_path=REPO, device="cpu")
    kp, names = io.load_data(cfg, base_path=root)
    return main.run_stac(cfg, kp, names, base_path=root, device="cpu")


@pytest.mark.parametrize("which", ["fit", "ik"])
def test_recompute_errors_matches_jax(artifacts, which):
    path = artifacts[0 if which == "fit" else 1]
    jax_demo, demo = _demo("graph_error_demo"), _demo("torch_graph_error_demo")
    got, d = demo.recompute_errors(path, device="cpu")
    want, _ = jax_demo.recompute_errors(path, base_path=REPO)
    n = CLIP if which == "fit" else N_FRAMES
    assert got.shape == (n,) and got.dtype == np.float32
    # Two float32 FKs of the same qpos and offsets: markers within ~1e-7 m,
    # so each frame's summed squared error (~1e-5 m^2) within 1e-4 relative.
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-10)
    # The file's own markers, recomputed: the artifact holds what run_stac's FK gave.
    markers = d.marker_sites.reshape(n, -1)
    np.testing.assert_allclose(got, ((d.kp_data[:n] - markers) ** 2).sum(-1), rtol=1e-4, atol=1e-10)
    # And in float64.
    got64, _ = demo.recompute_errors(path, device="cpu", dtype=torch.float64)
    assert got64.dtype == np.float64
    np.testing.assert_allclose(got, got64, rtol=1e-4, atol=1e-10)


def test_graph_error_demo_cli(artifacts, tmp_path):
    """The script on the CPU, plots and all, as a user runs it."""
    pytest.importorskip("matplotlib", reason="the plots need matplotlib")
    proc = subprocess.run(
        [sys.executable, str(REPO / "demos" / "torch_graph_error_demo.py"), str(artifacts[1]), "--cpu",
         "--clip-len", str(CLIP), "--save-prefix", str(tmp_path / "errors")],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "not good offset frames" in proc.stdout and "qpos change at clip seams" in proc.stdout
    assert (tmp_path / "errors.png").stat().st_size > 0
