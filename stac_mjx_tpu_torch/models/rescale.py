"""Uniform rescale of an ``mujoco.MjSpec`` (port of ``stac_mjx_tpu/models/rescale.py``).

Scales body positions, geom fromto/size/pos, mesh scales, actuator gear by
scale^2 (muscle cross-section) and the keyframes' qpos z, on a copy: the
input spec is untouched. Works on the spec's own objects, so it imports
nothing; ``models/builder.py`` hands it specs.
"""

from __future__ import annotations


def scale_spec(spec, scale: float):
    """A uniformly scaled copy of an MjSpec."""
    scaled = spec.copy()

    def _scale_subtree(parent) -> None:
        body = parent.first_body()
        while body:
            if body.pos is not None:
                body.pos = body.pos * scale
            for geom in body.geoms:
                geom.fromto = geom.fromto * scale
                geom.size = geom.size * scale
                if geom.pos is not None:
                    geom.pos = geom.pos * scale
            _scale_subtree(body)
            body = parent.next_body(body)

    for mesh in scaled.meshes:
        mesh.scale = mesh.scale * scale

    for actuator in scaled.actuators:
        actuator.gear = actuator.gear * scale * scale

    for key in scaled.keys:
        qpos = key.qpos
        qpos[2] = qpos[2] * scale
        key.qpos = qpos

    # As in the JAX package (and the reference it follows): the recursion
    # starts below the first top-level body, so that body's own pos and geoms,
    # and any sibling top-level bodies, are not scaled.
    first = scaled.worldbody.first_body()
    if first is not None:
        _scale_subtree(first)
    return scaled
