"""The port's ``scale_spec`` against the JAX package's on the same spec: the
cases of tests/test_rescale.py, each field compared bitwise between the two
packages and with the value that test expects."""

import mujoco
import numpy as np
import pytest

from stac_mjx_tpu.models.rescale import scale_spec as jax_scale_spec
from stac_mjx_tpu_torch.models.rescale import scale_spec
from test_rescale import SCALE_XML


def _spec():
    return mujoco.MjSpec.from_string(SCALE_XML)


def _geoms(body):
    return [(np.array(g.size), np.array(g.pos), np.array(g.fromto)) for g in body.geoms]


def _compiled(spec):
    m = spec.compile()
    return m.nbody, m.body_pos, m.geom_size, m.actuator_gear


# Each case: (scale, what to read from (input spec, scaled spec), the value tests/test_rescale.py expects).
CASES = {
    "descendant_positions_scale": (
        2.0, lambda s, out: [out.body("child").pos, out.body("grandchild").pos], [[0.4, 0.2, 0.6], [0, 0, -0.2]]),
    "first_top_level_body_pos_unscaled": (2.0, lambda s, out: out.body("top").pos, [1, 0, 0]),
    "geoms_scale": (
        3.0, lambda s, out: _geoms(out.body("child")) + _geoms(out.body("grandchild")) + _geoms(out.body("top")),
        None),
    "actuator_gear_scales_quadratically": (2.0, lambda s, out: out.actuators[0].gear, None),
    "keyframe_z_scales": (0.5, lambda s, out: out.keys[0].qpos, [0, 0, 0.35, 1, 0, 0, 0, 0.3]),
    "input_spec_untouched": (2.0, lambda s, out: [s.body("child").pos, s.body("top").geoms[0].size], None),
    "scaled_spec_compiles": (0.9, lambda s, out: _compiled(out), None),
    "identity_scale_roundtrip": (1.0, lambda s, out: _compiled(out)[1:], None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_scale_spec_matches_jax(case):
    scale, read, expected = CASES[case]
    got, specs = [], []  # the specs stay alive: what read returns may be views into them
    for fn in (scale_spec, jax_scale_spec):
        spec = _spec()
        specs.append((spec, fn(spec, scale)))
        got.append(read(*specs[-1]))
    port, ref = got
    for a, b in zip(np.asarray(port, dtype=object).ravel(), np.asarray(ref, dtype=object).ravel()):
        np.testing.assert_array_equal(np.asarray(a, np.float64), np.asarray(b, np.float64), err_msg=case)
    if expected is not None:
        np.testing.assert_allclose(np.asarray(port, np.float64)[..., : np.shape(expected)[-1]], expected)
    if case == "geoms_scale":
        np.testing.assert_allclose(port[0][0][0], 0.12)
        np.testing.assert_allclose(port[0][1], [0.03, 0.06, 0.09])
        np.testing.assert_allclose(port[1][0], [0.03, 0.06, 0.09])
    elif case == "actuator_gear_scales_quadratically":
        np.testing.assert_allclose(port[0], 20.0)
    elif case == "input_spec_untouched":
        np.testing.assert_allclose(port[0], [0.2, 0.1, 0.3])
    elif case == "scaled_spec_compiles":
        assert port[0] == 4
    elif case == "identity_scale_roundtrip":
        spec = _spec()
        for a, b in zip(port, _compiled(spec)[1:]):
            np.testing.assert_array_equal(a, b)
