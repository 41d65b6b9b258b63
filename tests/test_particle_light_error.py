"""Bounds for documented approximations.

1. Particle-light strided subset + energy compensation
   (lighting/particle_light.py) vs FULL per-particle evaluation — the
   round-1 verdict flagged this as unvalidated.
2. The scan shadow's default trace plane (mean(light_z) * 0.4) with
   lights at MIXED heights vs the exact march (default refine samples
   restore per-light 3D behavior).
"""

import numpy as np
import jax
import jax.numpy as jnp

from illuminant.core.config import QualitySettings
from illuminant.lighting.environment import (
    LightObstruction,
    LightingEnvironment,
    SphereLightSource,
)
from illuminant.lighting import cone_trace as ct
from illuminant.lighting import gbuffer as gbuf
from illuminant.lighting.particle_light import (
    ParticleLightSource,
    accumulate_particle_lights_jit,
)
from illuminant.lighting.scan_shadows import scan_visibility_jit as scan_visibility
from illuminant.particles.state import ParticleState
from illuminant.sdf.analytic import pack_scene


def _particle_state(n, seed=0):
    rng = np.random.default_rng(seed)
    st = ParticleState.empty(n)
    pos = np.zeros((n, 4), np.float32)
    pos[:, 0] = rng.uniform(20, 108, n)
    pos[:, 1] = rng.uniform(20, 108, n)
    pos[:, 2] = rng.uniform(10, 30, n)
    pos[:, 3] = 1.0  # alive
    col = np.ones((n, 4), np.float32)
    col[:, :3] = rng.uniform(0.3, 1.0, (n, 3))
    return st.replace(position=jnp.asarray(pos), color=jnp.asarray(col))


def test_particle_light_subset_error_bounded():
    n = 512
    state = _particle_state(n)
    env = LightingEnvironment(maximum_z=64.0)
    gb = gbuf.flat_ground(64, 64, env.uniforms())
    q = QualitySettings()
    template = SphereLightSource(radius=4.0, ramp_length=60.0,
                                 color=(1.0, 0.8, 0.6, 0.02),
                                 cast_shadows=False)

    def render(max_lights):
        src = ParticleLightSource(template=template, max_lights=max_lights)
        return np.asarray(accumulate_particle_lights_jit(
            None, gb, state, src, env.uniforms(), q,
            shadow_mode="march"))

    full = render(n)  # stride 1: every particle is a light
    sub = render(128)  # stride 4 + energy compensation

    assert full[..., :3].mean() > 1e-3
    # Total emitted energy preserved by the compensation.
    ratio = sub[..., :3].sum() / full[..., :3].sum()
    assert 0.85 < ratio < 1.15, ratio
    # Smooth aggregate illumination: bounded mean relative error.
    scale = np.maximum(full[..., :3], full[..., :3].mean())
    rel = np.abs(sub[..., :3] - full[..., :3]) / scale
    assert rel.mean() < 0.15, rel.mean()


def test_scan_trace_plane_mixed_height_lights():
    # A LOW light and a HIGH light over the same wall: the scan picks one
    # trace plane for its occlusion image, but per-light refinement must
    # keep each light's shadow length near the exact march's.
    scene = pack_scene(
        [LightObstruction.box((100.0, 64.0, 10.0), (4.0, 40.0, 10.0))]
    )
    q = QualitySettings()  # default refine samples
    lights = jnp.asarray(
        [[40.0, 64.0, 14.0],   # low light -> long shadow
         [40.0, 64.0, 80.0]],  # high light -> short shadow
        jnp.float32,
    )
    radii = jnp.asarray([5.0, 5.0])
    ramps = jnp.asarray([300.0, 300.0])
    vis = np.asarray(scan_visibility(scene, 128, 192, lights, radii,
                                     ramps, q))

    for li, z in ((0, 14.0), (1, 80.0)):
        for x in (110, 130, 160, 185):
            shaded = jnp.asarray([[x + 0.5, 64.5, 0.0]])
            march = float(ct.cone_trace_jit(
                scene, lights[li], radii[li], ramps[li], shaded,
                jnp.asarray([True]), q)[0])
            got = vis[li, 64, x]
            assert abs(got - march) < 0.25, (li, x, got, march)

    # Behavioral: the low light's umbra extends further than the high
    # light's.
    low_shadow = (vis[0, 64, 105:] < 0.5).sum()
    high_shadow = (vis[1, 64, 105:] < 0.5).sum()
    assert low_shadow > high_shadow + 10, (low_shadow, high_shadow)
