"""The port's NWB writer (``utils/convert.py``) against the JAX package's.

The two writers' files hold the same tree, datasets and attributes, apart
from the fresh ``object_id``s and ``file_create_date``; each package's
``io.load_nwb`` reads the other's file; and the cases of tests/test_convert.py
that need no reference asset run on the port (the spec donor is a file made
here with a ``/specifications`` group).
"""

import h5py
import numpy as np
import pytest
import scipy.io as spio

from stac_mjx_tpu import io as jax_io
from stac_mjx_tpu.utils import convert as jax_convert
from stac_mjx_tpu_torch import io
from stac_mjx_tpu_torch.utils import convert
from test_convert import _synthetic_recording

_FRESH = ("object_id", "file_create_date")


def _tree(path) -> dict:
    """Every group and dataset of a file: name -> (kind, shape, dtype, value, attrs), fresh ids left out."""
    out = {}

    def visit(name, obj):
        attrs = {k: v for k, v in obj.attrs.items() if k not in _FRESH and k != ".specloc"}
        if isinstance(obj, h5py.Dataset):
            value = None if name.endswith(_FRESH) else obj[()]
            out[name] = ("dataset", obj.shape, str(obj.dtype), value, attrs)
        else:
            out[name] = ("group", None, None, None, attrs)

    with h5py.File(path, "r") as f:
        visit("/", f)
        f.visititems(visit)
    return out


def _assert_same_tree(a, b) -> None:
    ta, tb = _tree(a), _tree(b)
    assert list(ta) == list(tb)
    for name in ta:
        (ka, sa, da, va, aa), (kb, sb, db, vb, ab) = ta[name], tb[name]
        assert (ka, sa, da) == (kb, sb, db), name
        np.testing.assert_array_equal(va, vb, err_msg=name)
        assert list(aa) == list(ab), name
        for k in aa:
            np.testing.assert_array_equal(aa[k], ab[k], err_msg=f"{name}@{k}")


def test_writer_matches_jax(tmp_path):
    data = _synthetic_recording(n_frames=6, n_kp=3, seed=2)
    names = ["snout", "tail", "paw"]
    kw = dict(fps=30.0, unit="mm", reference_frame="arena")
    _assert_same_tree(convert.save_nwb(tmp_path / "port.nwb", data, names, **kw),
                      jax_convert.save_nwb(tmp_path / "jax.nwb", data, names, **kw))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_file(tmp_path, writer):
    data = _synthetic_recording(n_frames=5, n_kp=2, seed=3)
    save, load = (convert.save_nwb, jax_io.load_nwb) if writer == "port" else (jax_convert.save_nwb, io.load_nwb)
    loaded, names = load(save(tmp_path / "rec.nwb", data, ["a", "b"]))
    assert names == ["a", "b"]
    np.testing.assert_array_equal(loaded, data)


def test_save_nwb_roundtrip(tmp_path):
    data = _synthetic_recording()
    names = [f"part_{i}" for i in range(data.shape[2])]
    loaded, loaded_names = io.load_nwb(convert.save_nwb(tmp_path / "rec.nwb", data, names, fps=25.0))
    assert loaded_names == names
    np.testing.assert_allclose(loaded, data)


def test_save_nwb_validates_shapes(tmp_path):
    for save in (convert.save_nwb, jax_convert.save_nwb):
        with pytest.raises(ValueError, match="frames, xyz, keypoints"):
            save(tmp_path / "x.nwb", np.zeros((5, 4, 2)), ["a", "b"])
        with pytest.raises(ValueError, match="names"):
            save(tmp_path / "x.nwb", np.zeros((5, 3, 2)), ["a"])


def test_mat_to_nwb_roundtrip(tmp_path):
    data = _synthetic_recording(n_frames=11, n_kp=3)
    spio.savemat(tmp_path / "rec.mat", {"pred": data})
    loaded, names = io.load_nwb(convert.mat_to_nwb(tmp_path / "rec.mat", tmp_path / "rec.nwb"))
    assert names == ["kp_0", "kp_1", "kp_2"]
    np.testing.assert_allclose(loaded, data)
    _assert_same_tree(tmp_path / "rec.nwb", jax_convert.mat_to_nwb(tmp_path / "rec.mat", tmp_path / "jax.nwb"))


def test_mat_to_nwb_with_label3d_names(tmp_path):
    data = _synthetic_recording(n_frames=3, n_kp=2)
    spio.savemat(tmp_path / "rec.mat", {"pred": data})
    spio.savemat(tmp_path / "names.mat", {"joint_names": np.array([["snout"], ["tail"]], dtype=object)})
    out = convert.mat_to_nwb(tmp_path / "rec.mat", tmp_path / "rec.nwb", names_path=tmp_path / "names.mat")
    assert io.load_nwb(out)[1] == ["snout", "tail"]


def test_describe_nwb(tmp_path, capsys):
    data = _synthetic_recording(n_frames=9, n_kp=2)
    out = convert.save_nwb(tmp_path / "rec.nwb", data, ["a", "b"], fps=10.0)
    info = convert.describe_nwb(out)
    assert info["n_frames"] == 9 and info["nodes"] == ["a", "b"]
    assert info["series"]["a"]["shape"] == (9, 3)
    assert info["series"]["a"]["duration_s"] == pytest.approx(0.8)
    printed = capsys.readouterr().out
    assert "2 keypoints, 9 frames" in printed
    assert jax_convert.describe_nwb(out) == info
    assert capsys.readouterr().out == printed


def test_save_nwb_structural_completeness(tmp_path):
    """The pynwb-shaped NWB 2.x tree: typed objects with distinct uuid4 ids,
    the required groups and datasets, the series' attributes."""
    out = convert.save_nwb(tmp_path / "rec.nwb", _synthetic_recording(n_frames=5, n_kp=2), ["a", "b"], fps=20.0)
    with h5py.File(out, "r") as f:
        assert (f.attrs["neurodata_type"], f.attrs["namespace"]) == ("NWBFile", "core")
        assert f.attrs["nwb_version"].startswith("2.")
        for path in ("acquisition", "analysis", "general", "stimulus/presentation", "stimulus/templates",
                     "file_create_date", "identifier", "session_description", "session_start_time",
                     "timestamps_reference_time"):
            assert path in f, path
        assert f["file_create_date"].shape == (1,)
        bh = f["processing/behavior"]
        pe = bh["PoseEstimation"]
        assert bh.attrs["neurodata_type"] == "ProcessingModule" and pe.attrs["namespace"] == "ndx-pose"
        assert pe["edges"].shape == (0, 2) and "version" in pe["source_software"].attrs
        s = pe["a"]
        assert s.attrs["neurodata_type"] == "PoseEstimationSeries"
        assert (s["data"].attrs["unit"], s["data"].attrs["conversion"], s["data"].attrs["resolution"]) == (
            "meters", 1.0, -1.0)
        assert (s["timestamps"].attrs["unit"], s["timestamps"].attrs["interval"]) == ("seconds", 1)
        assert "definition" in s["confidence"].attrs
        ids = [o.attrs["object_id"] for o in (f, bh, pe, pe["a"], pe["b"])]
        assert len(set(ids)) == 5 and all(len(i) == 36 for i in ids)


def _donor(path):
    """A file with a cached-spec tree, as a pynwb writer leaves one."""
    with h5py.File(path, "w") as f:
        ns = f.create_group("specifications/ndx-pose/0.1.1")
        ns.create_dataset("namespace", data=b'{"namespaces": [{"name": "ndx-pose"}]}')
    return path


def test_save_nwb_spec_donor_copy(tmp_path):
    data = _synthetic_recording(n_frames=3, n_kp=1)
    out = convert.save_nwb(tmp_path / "rec.nwb", data, ["snout"], spec_from=_donor(tmp_path / "donor.nwb"))
    with h5py.File(out, "r") as f:
        assert b"namespaces" in f["specifications/ndx-pose/0.1.1/namespace"][()]
        assert f[f.attrs[".specloc"]].name == "/specifications"
    loaded, names = io.load_nwb(out)
    assert names == ["snout"]
    np.testing.assert_allclose(loaded, data)
    _assert_same_tree(out, jax_convert.save_nwb(tmp_path / "jax.nwb", data, ["snout"], spec_from=tmp_path / "donor.nwb"))


def test_save_nwb_spec_donor_without_specs(tmp_path):
    data = _synthetic_recording(n_frames=2, n_kp=1)
    plain = convert.save_nwb(tmp_path / "plain.nwb", data, ["a"])
    with pytest.raises(ValueError, match="specifications"):
        convert.save_nwb(tmp_path / "x.nwb", data, ["a"], spec_from=plain)
