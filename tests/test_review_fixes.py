"""Regression tests for round-2 self-review findings."""

import numpy as np
import jax
import jax.numpy as jnp

from illuminant.core.config import QualitySettings
from illuminant.lighting.environment import (
    LightObstruction,
    LightingEnvironment,
    SphereLightSource,
)
from illuminant.lighting import gbuffer as gbuf
from illuminant.lighting.particle_light import (
    ParticleLightSource,
    accumulate_particle_lights_jit,
)
from illuminant.lighting.scan_shadows import scan_visibility_jit as scan_visibility
from illuminant.particles.formula import Formula1, Formula3
from illuminant.particles.spawner import FeedbackSpawner, PatternSpawner
from illuminant.particles.state import ParticleState
from illuminant.particles.system import ParticleSystem, \
    ParticleSystemConfig
from illuminant.sdf.analytic import pack_scene


def test_pattern_color_multiplies_constant_before_formula():
    # PatternSpawner.fx:70-74: pixel color scales the color CONSTANT,
    # then the formula adds offset/random terms UNtinted.
    from illuminant.particles.formula import Formula4

    img = np.zeros((1, 1, 4), np.float32)
    img[0, 0] = [0.5, 1.0, 1.0, 1.0]
    ps = PatternSpawner(
        image=img, min_rate=600.0, max_rate=600.0,
        life=Formula1(constant=5.0),
        color=Formula4(constant=(1.0, 1.0, 1.0, 1.0),
                       random_scale=(1.0, 0.0, 0.0, 0.0),
                       offset=(1.0, 0.0, 0.0, 0.0)),
    )
    sys_ = ParticleSystem(ParticleSystemConfig(capacity=128,
                                               updates_per_second=0.0,
                                               life_decay_per_second=0.1),
                          [ps])
    sys_.update(1.0 / 60.0)
    st = sys_.state
    live = np.asarray(st.live_mask())
    col = np.asarray(st.color)[live]
    assert live.sum() > 2
    # Linear formula: value = constant*pixel + (rnd + offset) * scale.
    # Pre-multiply (reference): r = 0.5 + (rnd + 1) in [1.5, 2.5).
    # Post-multiply (the bug): r = (1 + rnd + 1) * 0.5 in [1.0, 1.5).
    assert col[:, 0].min() > 1.45, col[:, 0].min()
    np.testing.assert_allclose(col[:, 1], 1.0, atol=1e-5)


def test_pattern_spawner_applies_pixel_colors():
    img = np.zeros((2, 2, 4), np.float32)
    img[0, 0] = [1.0, 0.2, 0.2, 1.0]  # red pixel
    img[0, 1] = [0.2, 1.0, 0.2, 1.0]  # green pixel
    img[1, :] = [0.0, 0.0, 0.0, 0.0]  # transparent -> excluded
    ps = PatternSpawner(image=img, pixel_scale=4.0, min_rate=600.0,
                        max_rate=600.0, life=Formula1(constant=5.0))
    sys_ = ParticleSystem(ParticleSystemConfig(capacity=256,
                                               updates_per_second=0.0,
                                               life_decay_per_second=0.1),
                          [ps])
    for _ in range(5):
        sys_.update(1.0 / 60.0)
    st = sys_.state
    live = np.asarray(st.live_mask())
    col = np.asarray(st.color)[live]
    assert live.sum() > 10
    # Red-pixel particles: r >> g; green-pixel particles: g >> r; both
    # kinds present (colors multiplied, not uniform).
    assert (col[:, 0] > col[:, 1] * 2).any()
    assert (col[:, 1] > col[:, 0] * 2).any()


def test_feedback_window_does_not_drift_on_zero_ticks():
    src_sys = ParticleSystem(
        ParticleSystemConfig(capacity=64, updates_per_second=0.0),
        [],
    )
    fb = FeedbackSpawner(source=src_sys, min_rate=0.0, max_rate=0.0)
    start = fb.read_cursor
    for _ in range(10):
        count = fb.begin_tick(0.0, 1.0 / 60.0)
        assert count == 0
        fb.advance_window(count)
    assert fb.read_cursor == start


def test_scan_no_edge_wraparound_shadow():
    # Occluder hugging the BOTTOM edge; light to its west. The top rows
    # must stay fully lit (jnp.roll wrap previously leaked the bottom
    # carry into row 0 along the sector diagonal).
    scene = pack_scene(
        [LightObstruction.box((100.0, 124.0, 16.0), (6.0, 6.0, 16.0))]
    )
    vis = np.asarray(scan_visibility(
        scene, 128, 256, jnp.asarray([[40.0, 124.0, 30.0]]),
        jnp.asarray([6.0]), jnp.asarray([400.0]), QualitySettings(),
        trace_z=jnp.float32(12.0),
    ))[0]
    assert vis[0:4, :].min() > 0.9, vis[0:4, :].min()
    # The real shadow (behind the box at the bottom) still exists.
    assert vis[120:128, 115:180].min() < 0.3


def test_particle_light_stipple_preserves_energy():
    n = 256
    st = ParticleState.empty(n)
    rng = np.random.default_rng(0)
    pos = np.zeros((n, 4), np.float32)
    pos[:, 0] = rng.uniform(10, 54, n)
    pos[:, 1] = rng.uniform(10, 54, n)
    pos[:, 2] = 10.0
    pos[:, 3] = 1.0
    st = st.replace(position=jnp.asarray(pos))
    env = LightingEnvironment(maximum_z=64.0)
    gb = gbuf.flat_ground(64, 64, env.uniforms())
    template = SphereLightSource(radius=3.0, ramp_length=40.0,
                                 color=(1.0, 1.0, 1.0, 0.05),
                                 cast_shadows=False)
    full = np.asarray(accumulate_particle_lights_jit(
        None, gb, st, ParticleLightSource(template=template,
                                          max_lights=n),
        env.uniforms(), QualitySettings(), shadow_mode="march"))
    half = np.asarray(accumulate_particle_lights_jit(
        None, gb, st, ParticleLightSource(template=template,
                                          max_lights=n,
                                          stipple_factor=0.5),
        env.uniforms(), QualitySettings(), shadow_mode="march"))
    ratio = half[..., :3].sum() / full[..., :3].sum()
    assert 0.8 < ratio < 1.2, ratio  # energy-compensated thinning
    # And it actually thinned: images differ.
    assert np.abs(half - full).max() > 1e-3
