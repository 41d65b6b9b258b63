"""Tiled light culling (lighting/tiled_lights.py): exactness vs the
dense full evaluation, binning correctness, and capacity diagnostics."""

import numpy as np
import jax.numpy as jnp

from illuminant.core.config import QualitySettings
from illuminant.lighting import gbuffer as gbuf
from illuminant.lighting.environment import (
    LightingEnvironment,
    SphereLightSource,
)
from illuminant.lighting.particle_light import (
    ParticleLightSource,
    accumulate_particle_lights,
)
from illuminant.lighting.tiled_lights import (
    accumulate_sphere_lights_tiled,
    bin_lights_to_tiles,
)
from illuminant.particles.state import ParticleState
from illuminant.sdf.analytic import pack_scene


def _setup(n=96, h=96, w=160, seed=3):
    env = LightingEnvironment(ground_z=0.0, maximum_z=64.0)
    gb = gbuf.flat_ground(h, w, env.uniforms())
    rng = np.random.default_rng(seed)
    st = ParticleState.empty(n)
    pos = np.zeros((n, 4), np.float32)
    pos[:, 0] = rng.uniform(-10, w + 10, n)  # some off-screen
    pos[:, 1] = rng.uniform(-10, h + 10, n)
    pos[:, 2] = rng.uniform(4, 20, n)
    pos[:, 3] = (rng.uniform(0, 1, n) > 0.2).astype(np.float32)
    col = np.ones((n, 4), np.float32)
    col[:, :3] = rng.uniform(0.2, 1.0, (n, 3))
    col[:, 3] = rng.uniform(0.5, 1.0, n)
    st = st.replace(position=jnp.asarray(pos), color=jnp.asarray(col))
    return env, gb, st


def test_tiled_matches_dense_full_evaluation():
    env, gb, st = _setup()
    template = SphereLightSource(radius=2.0, ramp_length=24.0,
                                 color=(1.0, 0.9, 0.8, 0.06),
                                 cast_shadows=False)
    q = QualitySettings()
    scene = pack_scene([])
    dense = np.asarray(accumulate_particle_lights(
        scene, gb, st,
        ParticleLightSource(template=template, max_lights=st.capacity,
                            method="subset"),
        env.uniforms(), q))
    tiled = np.asarray(accumulate_particle_lights(
        scene, gb, st,
        ParticleLightSource(template=template, method="tiled",
                            tile=32, tile_capacity=64),
        env.uniforms(), q))
    scale = max(dense.max(), 1e-6)
    assert np.abs(tiled - dense).max() / scale < 0.02, (
        np.abs(tiled - dense).max(), scale)


def test_auto_method_picks_tiled_for_shadowless():
    # The shadowless/unramped default routes through the exact tiled
    # path: its result must match forcing method="tiled" bit-for-bit.
    env, gb, st = _setup(n=40)
    template = SphereLightSource(radius=2.0, ramp_length=18.0,
                                 color=(1.0, 1.0, 1.0, 0.05),
                                 cast_shadows=False)
    q = QualitySettings()
    scene = pack_scene([])
    auto = np.asarray(accumulate_particle_lights(
        scene, gb, st, ParticleLightSource(template=template),
        env.uniforms(), q))
    tiled = np.asarray(accumulate_particle_lights(
        scene, gb, st,
        ParticleLightSource(template=template, method="tiled"),
        env.uniforms(), q))
    assert np.array_equal(auto, tiled)


def test_binning_covers_influence_discs():
    # Every (light, tile) pair whose disc/box distance is within the
    # influence radius must appear in the bin lists (capacity permitting).
    rng = np.random.default_rng(7)
    n, tile, th, tw = 50, 32, 3, 5
    x = jnp.asarray(rng.uniform(-20, tw * 32 + 20, n), jnp.float32)
    y = jnp.asarray(rng.uniform(-20, th * 32 + 20, n), jnp.float32)
    live = jnp.asarray(rng.uniform(0, 1, n) > 0.3)
    influence = 40.0
    idx, mask, dropped = bin_lights_to_tiles(
        x, y, live, influence, tile, th, tw, capacity=64)
    assert int(dropped) == 0
    idx = np.asarray(idx)
    mask = np.asarray(mask)
    xs, ys_, lv = np.asarray(x), np.asarray(y), np.asarray(live)
    for t in range(th * tw):
        got = set(idx[t][mask[t]].tolist())
        ty, tx = divmod(t, tw)
        x0, y0 = tx * tile, ty * tile
        for i in range(n):
            if not lv[i]:
                assert i not in got
                continue
            dx = xs[i] - min(max(xs[i], x0), x0 + tile)
            dy = ys_[i] - min(max(ys_[i], y0), y0 + tile)
            # The per-axis box test is conservative: every light whose
            # true disc reaches the tile MUST be binned; extras are
            # bounded by the box.
            if dx ** 2 + dy ** 2 <= influence ** 2:
                assert i in got, (t, i)
            if i in got:
                assert abs(dx) <= influence and abs(dy) <= influence


def test_capacity_overflow_reported():
    # 80 co-located lights vs capacity 16: the overflow count must be
    # reported, not silent.
    n = 80
    x = jnp.full((n,), 16.0)
    y = jnp.full((n,), 16.0)
    live = jnp.ones((n,), bool)
    idx, mask, dropped = bin_lights_to_tiles(
        x, y, live, 8.0, 32, 2, 2, capacity=16)
    assert int(dropped) == n - 16
    assert int(mask.sum()) == 16


def test_tiled_respects_fullbright_and_ao_parity():
    # With an obstruction field + AO template, tiled still matches the
    # dense path (AO is per-pixel since the template radius is shared).
    from illuminant.lighting.environment import LightObstruction

    env, gb, st = _setup(n=48, seed=11)
    scene = pack_scene([
        LightObstruction.box((60.0, 40.0, 8.0), (10.0, 10.0, 8.0)),
    ])
    template = SphereLightSource(radius=2.0, ramp_length=20.0,
                                 color=(0.9, 0.9, 1.0, 0.06),
                                 cast_shadows=False,
                                 ambient_occlusion_radius=4.0,
                                 ambient_occlusion_opacity=0.7)
    q = QualitySettings()
    dense = np.asarray(accumulate_particle_lights(
        scene, gb, st,
        ParticleLightSource(template=template, max_lights=st.capacity,
                            method="subset"),
        env.uniforms(), q))
    tiled = np.asarray(accumulate_particle_lights(
        scene, gb, st,
        ParticleLightSource(template=template, method="tiled",
                            tile=32, tile_capacity=64),
        env.uniforms(), q))
    scale = max(dense.max(), 1e-6)
    assert np.abs(tiled - dense).max() / scale < 0.02


def test_tiled_covers_elevated_pixels():
    # 2.5D: pixels with nonzero relative_y live in screen rows their
    # world y does not predict — per-tile y bounds must still bin the
    # lights that reach them (review finding: structure tops rendered
    # black). Build a G-buffer whose lower half is "elevated" with
    # relative_y = -28 and compare tiled vs dense.
    env, gb, st = _setup(n=48, seed=5)
    rel = np.zeros(gb.shape, np.float32)
    rel[64:, :] = -28.0
    gb = gb.replace(relative_y=jnp.asarray(rel))
    template = SphereLightSource(radius=2.0, ramp_length=20.0,
                                 color=(1.0, 1.0, 1.0, 0.08),
                                 cast_shadows=False)
    q = QualitySettings()
    scene = pack_scene([])
    dense = np.asarray(accumulate_particle_lights(
        scene, gb, st,
        ParticleLightSource(template=template, max_lights=st.capacity,
                            method="subset"),
        env.uniforms(), q))
    tiled = np.asarray(accumulate_particle_lights(
        scene, gb, st,
        ParticleLightSource(template=template, method="tiled",
                            tile=32, tile_capacity=64),
        env.uniforms(), q))
    scale = max(dense.max(), 1e-6)
    assert np.abs(tiled - dense).max() / scale < 0.02, (
        np.abs(tiled - dense).max(), scale)


def test_tiled_covers_squashed_y_falloff():
    # falloff_y_factor < 1 stretches the light's y reach by 1/factor;
    # binning must widen accordingly (review finding: hard truncation
    # seam at the isotropic disc boundary).
    env, gb, st = _setup(n=32, seed=9)
    template = SphereLightSource(radius=2.0, ramp_length=16.0,
                                 color=(1.0, 1.0, 1.0, 0.1),
                                 falloff_y_factor=0.4,
                                 cast_shadows=False)
    q = QualitySettings()
    scene = pack_scene([])
    dense = np.asarray(accumulate_particle_lights(
        scene, gb, st,
        ParticleLightSource(template=template, max_lights=st.capacity,
                            method="subset"),
        env.uniforms(), q))
    tiled = np.asarray(accumulate_particle_lights(
        scene, gb, st,
        ParticleLightSource(template=template, method="tiled",
                            tile=32, tile_capacity=64),
        env.uniforms(), q))
    scale = max(dense.max(), 1e-6)
    assert np.abs(tiled - dense).max() / scale < 0.02


def test_stipple_energy_consistent_across_paths():
    # Both paths preserve total emitted energy under stipple, so the
    # auto route never changes scene brightness (review finding).
    env, gb, st = _setup(n=64, seed=13)
    template = SphereLightSource(radius=2.0, ramp_length=22.0,
                                 color=(1.0, 1.0, 1.0, 0.06),
                                 cast_shadows=False)
    q = QualitySettings()
    scene = pack_scene([])
    outs = {}
    for method in ("subset", "tiled"):
        outs[method] = np.asarray(accumulate_particle_lights(
            scene, gb, st,
            ParticleLightSource(template=template, stipple_factor=0.5,
                                max_lights=st.capacity, method=method,
                                tile=32, tile_capacity=64),
            env.uniforms(), q))
    e_sub = outs["subset"][..., :3].sum()
    e_til = outs["tiled"][..., :3].sum()
    assert abs(e_til - e_sub) / max(e_sub, 1e-6) < 0.25, (e_sub, e_til)


def test_auto_density_gate_routes_dense_washes_to_subset():
    # A set whose expected per-pixel overlap exceeds the tile capacity
    # must NOT route tiled (capacity would silently drop energy).
    env, gb, st = _setup(n=96, h=64, w=64)
    template = SphereLightSource(radius=2.0, ramp_length=40.0,
                                 color=(1.0, 1.0, 1.0, 0.05),
                                 cast_shadows=False)
    q = QualitySettings()
    scene = pack_scene([])
    auto = np.asarray(accumulate_particle_lights(
        scene, gb, st, ParticleLightSource(template=template),
        env.uniforms(), q))
    subset = np.asarray(accumulate_particle_lights(
        scene, gb, st,
        ParticleLightSource(template=template, method="subset"),
        env.uniforms(), q))
    assert np.array_equal(auto, subset)


def test_window_deficit_reported():
    # Relief beyond the static candidate window is reported, not silent.
    env, gb, _ = _setup(n=8)
    rel = np.zeros(gb.shape, np.float32)
    rel[:, :] = -150.0
    gb2 = gb.replace(relative_y=jnp.asarray(rel))
    template = SphereLightSource(radius=2.0, ramp_length=10.0,
                                 cast_shadows=False)
    pos = jnp.zeros((8, 4)).at[:, 3].set(1.0)
    col = jnp.ones((8, 4))
    _, diag = accumulate_sphere_lights_tiled(
        None, gb2, pos, col, jnp.ones((8,), bool), template,
        env.uniforms(), tile=32, capacity=8, max_relative_y=32.0)
    assert float(diag["window_deficit_px"]) > 100.0
    _, diag2 = accumulate_sphere_lights_tiled(
        None, gb2, pos, col, jnp.ones((8,), bool), template,
        env.uniforms(), tile=32, capacity=8, max_relative_y=200.0)
    assert float(diag2["window_deficit_px"]) == 0.0
