"""Windowed (bounded) light evaluation == full-frame evaluation.

The window must fully contain a light's support for exact equality; the
clamped-at-edge path (window shifted, light off-center in it) must also
match. Mirrors the reference's per-light instanced quads
(LightingRenderer.cs:1149-1166)."""

import numpy as np
import jax.numpy as jnp

from illuminant.core.config import QualitySettings
from illuminant.lighting import gbuffer as gbuf
from illuminant.lighting.environment import (
    LightObstruction,
    LightingEnvironment,
)
from illuminant.lighting.volumetric import (
    VolumetricLightSource,
    accumulate_volumetric_lights,
    pack_volumetric_lights,
)
from illuminant.lighting.windowed import accumulate_windowed
from illuminant.sdf.analytic import pack_scene


def _take_light(lights, i):
    import jax

    return jax.tree.map(lambda a: a[i:i + 1], lights)


def _setup(h=96, w=160):
    env = LightingEnvironment(ground_z=0.0, maximum_z=64.0)
    env.obstructions.append(
        LightObstruction.box((70.0, 40.0, 10.0), (6.0, 6.0, 10.0)))
    gb = gbuf.flat_ground(h, w, env.uniforms())
    scene = pack_scene(env.obstructions)
    return env, gb, scene


def _volumetric(cx, cy):
    return VolumetricLightSource(
        shape=1,  # cone
        start_position=(cx, cy, 24.0), end_position=(cx + 20.0, cy, 2.0),
        start_radius=10.0, end_radius=16.0, volumetricity=0.8,
        ramp_length=8.0, color=(1.0, 0.9, 0.7, 0.8),
    )


def _compare(cx, cy, win):
    env, gb, scene = _setup()
    q = QualitySettings()
    vl = pack_volumetric_lights([_volumetric(cx, cy)])
    full = np.asarray(accumulate_volumetric_lights(
        scene, gb, vl, env.uniforms(), q))
    base = jnp.zeros((gb.shape[0], gb.shape[1], 4), jnp.float32)
    centers = jnp.asarray([[cx + 10.0, cy]], jnp.float32)
    windowed = np.asarray(accumulate_windowed(
        base, gb, centers, win,
        lambda i, gbw: accumulate_volumetric_lights(
            scene, gbw, _take_light(vl, i), env.uniforms(), q),
    ))
    return full, windowed


def test_windowed_matches_full_center():
    full, windowed = _compare(60.0, 48.0, 96)
    assert np.abs(windowed - full).max() < 1e-5


def test_windowed_matches_full_at_edge():
    # Light near the frame corner: the window clamps and the light sits
    # off-center in it — values must still match the full evaluation.
    full, windowed = _compare(8.0, 8.0, 96)
    assert np.abs(windowed - full).max() < 1e-5
