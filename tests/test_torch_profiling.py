"""The port's profiling layer (``stac_mjx_tpu_torch.utils.profiling``) against
the JAX package's: the phase registry, ``Stac``'s phases under the JAX
names, and a CPU ``device_trace`` read back by ``op_table``."""

import numpy as np
import torch

from _torch_common import THROUGHPUT, bridge, torch_stac
from stac_mjx_tpu.utils import profiling as jprof
from stac_mjx_tpu_torch.models.firstparty import make_recording
from stac_mjx_tpu_torch.utils import profiling


def test_phase_registry_matches_jax():
    """The same phases through both registries: the same names and counts,
    and report/reset behave alike."""
    for prof in (jprof, profiling):
        prof.reset()
        for name in ("fit_offsets", "ik_only", "ik_only", "fit_offsets_sharded"):
            with prof.phase(name):
                pass
    got, want = profiling.report(), jprof.report()
    assert {k: v["count"] for k, v in got.items()} == {k: v["count"] for k, v in want.items()}
    assert all(v["total_s"] >= 0.0 for v in got.values())
    profiling.reset()
    jprof.reset()
    assert profiling.report() == jprof.report() == {}


def test_stac_entry_points_record_their_phases():
    """fit_offsets, ik_only, fit_offsets_sharded and ik_only_global (one
    process: no group) each add one count under the JAX package's names."""
    from stac_mjx_tpu_torch.parallel.distributed import make_global_clips, make_global_frames, pod_mesh

    st = torch_stac(dict(THROUGHPUT, n_frames_per_clip=4), {"N_ITERS": 1})
    kp, _, _, _ = make_recording(bridge.load_bundle(), n_frames=8, seed=0, device="cpu")
    mesh = pod_mesh("cpu")
    profiling.reset()
    fit = st.fit_offsets(kp)
    st.ik_only(kp, fit.offsets)
    st.fit_offsets_sharded(make_global_frames(kp.numpy(), mesh), mesh)
    st.ik_only_global(make_global_clips(kp.numpy().reshape(2, 4, -1), mesh), fit.offsets, mesh)
    rep = profiling.report()
    assert {k: v["count"] for k, v in rep.items()} == {
        "fit_offsets": 1, "ik_only": 1, "fit_offsets_sharded": 1, "ik_only_global": 1}
    profiling.reset()


def test_device_trace_and_op_table_on_the_cpu(tmp_path):
    """A CPU trace of a few ops (with an annotation), summed by op_table:
    each op's count is what ran; an empty directory gives the JAX
    op_table's empty result."""
    assert profiling.op_table(str(tmp_path / "none")) == jprof.op_table(str(tmp_path / "none"))
    a = torch.ones(64, 64)
    with profiling.device_trace(str(tmp_path)):
        with profiling.annotate("three_matmuls"):
            for _ in range(3):
                a = a @ a / 64.0
        a = a + 1.0
    table = profiling.op_table(str(tmp_path), device_substr="CPU", top=100)
    ops = {o["op"]: o for o in table["ops"]}
    assert ops["aten::mm"]["count"] == 3
    assert ops["aten::add"]["count"] == 1
    assert all(o["category"] == "cpu_op" for o in ops.values())
    assert table["total_op_us"] > 0 and table["copy_formatting_pct"] == 0.0
    assert np.isclose(sum(o["pct"] for o in table["ops"]), 100.0, atol=0.1 * len(ops))
    # No CUDA activity on the CPU: the kernel table is empty.
    assert profiling.op_table(str(tmp_path))["ops"] == []
