"""Round-4 advice/verdict pins: the half-res extra-family lever's bound,
particle-light tiled overflow diagnostics, and windowed-light bounds
safety (round-3 review items).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from illuminant.core.config import QualitySettings
from illuminant.lighting.environment import (
    LightingEnvironment,
    SphereLightSource,
)
from illuminant.lighting.gbuffer import flat_ground
from illuminant.lighting.particle_light import (
    ParticleLightSource,
    accumulate_particle_lights,
)
from illuminant.lighting.windowed import (
    accumulate_windowed,
    window_deficit_px,
    window_for_support,
)


def _flagship_frame(scale: float, h=144, w=256):
    from illuminant.scenes import build_flagship

    scene = build_flagship(
        height=h, width=w, n_lights=4, capacity=1 << 10, spawn_max=256,
        full_family=True,
        quality=QualitySettings(extra_family_scale=scale),
    )
    state = scene.system.state
    key = jax.random.key(0)
    env_u = scene.environment.uniforms()
    avg = jnp.asarray(0.5, jnp.float32)
    spawn = jnp.asarray(scene.spawner.spawn_max, jnp.int32)
    img = None
    for i in range(4):
        # avg kept FIXED: identical exposure for both runs, so the diff
        # below measures the lever, not the auto-exposure feedback.
        img, state, _avg, _ = scene.frame(
            state, avg, key, scene.volume, scene.gbuffer,
            scene.sphere_lights, env_u, spawn, frame_index=i)
    return np.asarray(img)


def test_halfres_extra_family_bound():
    """The half-res extra-family lever (QualitySettings.
    extra_family_scale=0.5) is band-limited: vs full-res accumulation
    the uint8 output differs by ~0 almost everywhere, with a sub-percent
    fraction of shadow-silhouette pixels where the half-res scan shifts
    an edge by a pixel (an edge shift, not an energy loss). Measured at
    540x960 on the ramp-softened flagship: mean 0.023 LSB, p99 1 LSB, frac(>2 LSB) 0.086%. Reference behavior
    at scale 1.0: every family shades at lightmap res in one pass
    (LightingRenderer.cs:1004-1168) — the parity preset's setting."""
    half = _flagship_frame(0.5)
    full = _flagship_frame(1.0)
    d = np.abs(half.astype(np.int32) - full.astype(np.int32))
    assert float(d.mean()) <= 0.25, d.mean()
    assert float((d > 2).mean()) <= 0.01, (d > 2).mean()
    # Energy parity: the lever must not systematically gain/lose light.
    signed = half.astype(np.int64).sum() - full.astype(np.int64).sum()
    assert abs(signed) / d.size <= 0.25, signed / d.size


def _clustered_system(n=64, at=(64.0, 64.0, 20.0)):
    from illuminant.particles.system import (
        ParticleSystem, ParticleSystemConfig)

    cfg = ParticleSystemConfig(capacity=n, updates_per_second=0.0,
                               life_decay_per_second=0.0)
    system = ParticleSystem(cfg, [])
    pos = np.zeros((n, 4), np.float32)
    col = np.zeros((n, 4), np.float32)
    pos[:] = [*at, 10.0]
    col[:] = [1.0, 0.8, 0.2, 1.0]
    system.state = system.state.replace(position=jnp.asarray(pos),
                                        color=jnp.asarray(col))
    return system


def test_particle_light_tiled_overflow_diagnostic():
    """A dense particle cluster overflowing the per-tile light capacity
    is REPORTED, not silent (emitters cluster by
    nature; the reference just instances every quad so it never drops,
    ParticleLight.fx + LightingRenderer.cs:1138-43)."""
    system = _clustered_system(64)
    env = LightingEnvironment()
    gb = flat_ground(128, 128, env.uniforms())
    src = ParticleLightSource(
        template=SphereLightSource(radius=6.0, ramp_length=40.0,
                                   cast_shadows=False),
        method="tiled", tile=32, tile_capacity=8,
    )
    img, dropped = accumulate_particle_lights(
        None, gb, system.state, src, env.uniforms(), QualitySettings(),
        shadow_mode="march", return_diagnostics=True,
    )
    assert int(dropped) > 0  # 64 coincident lights vs capacity 8
    assert float(jnp.max(img)) > 0.0


def test_particle_light_auto_shuns_overflowing_cluster():
    """method='auto' must NOT route a set whose expected per-tile count
    exceeds the tile capacity to the tiled path — the subset path's
    strided sampling (dropped == 0 by construction) is the safe
    fallback for dense sets."""
    system = _clustered_system(64)
    env = LightingEnvironment()
    gb = flat_ground(128, 128, env.uniforms())
    src = ParticleLightSource(
        template=SphereLightSource(radius=6.0, ramp_length=60.0,
                                   cast_shadows=False),
        method="auto", tile=32, tile_capacity=8, max_lights=64,
    )
    img, dropped = accumulate_particle_lights(
        None, gb, system.state, src, env.uniforms(), QualitySettings(),
        shadow_mode="march", return_diagnostics=True,
    )
    # exp_binned = 64 lights * (2*66+32)^2 / 128^2 ~ 105 >> capacity 8:
    # auto picks the subset path, which reports zero drops.
    assert int(dropped) == 0
    assert float(jnp.max(img)) > 0.0


def test_windowed_truncation_diagnostic():
    """An oversized light either fits its derived window or reports a
    positive deficit (the reference sizes every instanced quad from its
    light's bounds so it never truncates, LightingRenderer.cs:1193-1446)."""
    h = w = 128
    env = LightingEnvironment().uniforms()
    gb = flat_ground(h, w, env)
    lightmap = jnp.zeros((h, w, 3), jnp.float32)
    centers = jnp.asarray([[64.0, 64.0]], jnp.float32)

    def accum(_i, gbw):
        return jnp.ones(gbw.shape + (3,), jnp.float32)

    # support 24 px -> window 48 fits: deficit 0.
    win = window_for_support(24.0, h, w)
    assert win >= 48
    _, deficit = accumulate_windowed(
        lightmap, gb, centers, win, accum,
        support_px=jnp.asarray([24.0]))
    assert int(deficit) == 0
    # support 200 px in a 128 px frame: the window clamps to the frame
    # and the deficit reports the truncation.
    win_big = window_for_support(200.0, h, w)
    assert win_big == max(h, w)
    _, deficit2 = accumulate_windowed(
        lightmap, gb, centers, win_big, accum,
        support_px=jnp.asarray([200.0]))
    assert int(deficit2) == 2 * 200 - 128


def test_window_for_support_sizing():
    assert window_for_support(10.0, 1080, 1920) == 32  # 2*10 -> /16 -> 32
    assert window_for_support(0.5, 1080, 1920) == 16  # floor: one tile
    assert window_for_support(1e6, 1080, 1920) == 1920  # frame clamp
    assert int(window_deficit_px(100.0, 384)) == 0
    assert int(window_deficit_px(200.0, 384)) == 16
