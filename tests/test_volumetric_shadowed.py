"""Shadowed volumetric light vs a numpy march oracle.

The inner occlusion march (VolumetricLightCore.fxh:358-392) must darken
column samples whose ray from the shape origin penetrates an occluder —
verified against an exact numpy re-implementation of the fxh loop.
"""

import numpy as np
import jax.numpy as jnp

from illuminant.core.config import QualitySettings
from illuminant.lighting.environment import (
    LightObstruction,
    LightingEnvironment,
)
from illuminant.lighting import gbuffer as gbuf
from illuminant.lighting.volumetric import (
    SHAPE_ELLIPSOID,
    VolumetricLightSource,
    accumulate_volumetric_lights_jit,
    pack_volumetric_lights,
)
from illuminant.sdf.analytic import pack_scene


def _box_sdf(p, center, size):
    d = np.abs(p - center) - size
    outside = np.linalg.norm(np.maximum(d, 0.0))
    inside = min(max(d[0], max(d[1], d[2])), 0.0)
    return outside + inside


def _oracle_occlusion(origin, target, center, size, min_step=3.0,
                      inner_steps=16, d0=0.33):
    """fxh:358-392 numpy mirror (scene = one box, distance clamp 128)."""
    toward = target - origin
    md = np.linalg.norm(toward)
    along = toward / md
    d = d0
    occ = 1.0
    for _ in range(inner_steps):
        sp = origin + along * d
        s = min(_box_sdf(sp, center, size), 128.0)
        occ = min(max(s * 0.5, 0.0), 1.0)
        if s <= -0.1:
            return 0.0
        d += max(abs(s) * 0.99, min_step)
        if d >= md:
            break
    return occ


def test_shadowed_volumetric_matches_march_oracle():
    center = np.asarray([44.0, 32.0, 10.0])
    size = np.asarray([4.0, 20.0, 10.0])
    env = LightingEnvironment(maximum_z=40.0)
    env.obstructions.append(LightObstruction.box(tuple(center),
                                                 tuple(size)))
    scene = pack_scene(env.obstructions)
    q = QualitySettings()
    src = VolumetricLightSource(
        shape=SHAPE_ELLIPSOID,
        start_position=(16.0, 32.0, 12.0),
        end_position=(70.0, 30.0, 14.0),  # ellipsoid: end = radii
        start_radius=6.0,
        volumetricity=1.0,
        color=(1.0, 1.0, 1.0, 1.0),
        # Per-light CastsShadows gate (lightProperties.w, fxh:451): a
        # shadowed PASS only occludes lights with the flag set.
        cast_shadows=True,
    )
    lights = pack_volumetric_lights([src])
    gb = gbuf.flat_ground(64, 96, env.uniforms())

    lm_open = np.asarray(accumulate_volumetric_lights_jit(
        scene, gb, lights, env.uniforms(), q, shadowed=False))
    lm_shadow = np.asarray(accumulate_volumetric_lights_jit(
        scene, gb, lights, env.uniforms(), q, shadowed=True))

    # Behind the wall (east side): the origin->sample rays pass through
    # the box, so the shadowed variant is darker.
    behind = (32, 60)
    open_v = lm_open[behind][3]
    shadow_v = lm_shadow[behind][3]
    assert open_v > 0.05, open_v
    assert shadow_v < open_v * 0.5, (open_v, shadow_v)

    # In front of the wall (between origin and box) shadowing is mild.
    front = (32, 30)
    assert lm_shadow[front][3] > lm_open[front][3] * 0.6

    # Quantitative: single-ray oracle at the column mid-sample height
    # agrees with the implementation's occlusion ordering.
    origin = np.asarray([16.0, 32.0, 12.0])
    occ_behind = _oracle_occlusion(origin,
                                   np.asarray([60.5, 32.5, 10.0]),
                                   center, size)
    occ_front = _oracle_occlusion(origin,
                                  np.asarray([30.5, 32.5, 10.0]),
                                  center, size)
    assert occ_behind < 0.2
    assert occ_front > occ_behind


def test_cast_shadows_flag_gates_per_light():
    """A shadowed pass leaves cast_shadows=False lights unshadowed
    (lightProperties.w, VolumetricLightCore.fxh:451)."""
    center = np.asarray([44.0, 32.0, 10.0])
    size = np.asarray([4.0, 20.0, 10.0])
    env = LightingEnvironment(maximum_z=40.0)
    env.obstructions.append(LightObstruction.box(tuple(center),
                                                 tuple(size)))
    scene = pack_scene(env.obstructions)
    q = QualitySettings()
    src = VolumetricLightSource(
        shape=SHAPE_ELLIPSOID,
        start_position=(16.0, 32.0, 12.0),
        end_position=(70.0, 30.0, 14.0),
        start_radius=6.0, volumetricity=1.0,
        color=(1.0, 1.0, 1.0, 1.0), cast_shadows=False,
    )
    lights = pack_volumetric_lights([src])
    gb = gbuf.flat_ground(64, 96, env.uniforms())
    lm_open = np.asarray(accumulate_volumetric_lights_jit(
        scene, gb, lights, env.uniforms(), q, shadowed=False))
    lm_shadow = np.asarray(accumulate_volumetric_lights_jit(
        scene, gb, lights, env.uniforms(), q, shadowed=True))
    np.testing.assert_allclose(lm_shadow, lm_open, atol=1e-5)
