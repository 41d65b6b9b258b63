"""Regression tests for the round-3 self-review findings.

1. rasterize_tiled_alpha must reject channels=3 (that payload packs
   (b, size) into one operand and carries no alpha — before the guard it
   silently composited full transparency).
2. The nomination-scale upsample must not bilinearly blend no-blocker
   k_frac/exit_frac values into real ones at umbra edges (normalized
   convolution weighted by the blocker mask) — a plain bilinear produced
   a lit fringe inside umbra edges for far pseudo-center lights.
3. Spawner.begin_tick(granularity=D) keeps host accounting exact when
   the device rounds the spawn count down to a multiple of D.
4. spawn(sub_rings=D) with spawn_max > capacity falls back to a scatter
   instead of crashing on a negative pad.
5. ParticleSystem.render consumes config.z_formula / size_from_z.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from illuminant.core.config import QualitySettings
from illuminant.lighting.environment import LightObstruction
from illuminant.lighting.scan_shadows import scan_visibility_jit as scan_visibility
from illuminant.sdf.analytic import pack_scene


def test_alpha_rejects_channels3():
    from illuminant.raster.tiled import (
        TiledRasterConfig, rasterize_tiled_alpha)

    cfg = TiledRasterConfig(height=32, width=32, tile=16, bin_capacity=8,
                            channels=3)
    n = 16
    args = (jnp.full((n,), 8.0), jnp.full((n,), 8.0),
            jnp.ones((n, 4)), jnp.full((n,), 2.0), jnp.ones((n,), bool))
    with pytest.raises(AssertionError):
        rasterize_tiled_alpha(cfg, *args)


def test_nomination_upsample_masked_fractions():
    """The nominated-field upsample is a normalized convolution weighted
    by the blocker mask: fractions at a mask edge must NOT decay toward
    the no-blocker pixels' meaningless 0 (which drags the refine sample
    toward the light), while the min_d majority vote stays intact."""
    import jax.numpy as jnp
    from illuminant.lighting.scan_shadows import _upsample_nominated

    big = 1e9
    min_d = jnp.asarray([[big, 2.0, 2.0, 2.0]], jnp.float32)[None]
    k = jnp.asarray([[0.0, 0.8, 0.8, 0.8]], jnp.float32)[None]
    e = jnp.asarray([[0.0, 0.9, 0.9, 0.9]], jnp.float32)[None]
    d2, k2, e2, hb, _ex = _upsample_nominated(min_d, k, e, 1)
    d2, k2, e2, hb = (np.asarray(a)[0] for a in (d2, k2, e2, hb))
    # Every upsampled pixel with a blocker majority keeps the TRUE
    # fraction (a plain bilinear gave 0.2 / 0.6 at the edge).
    assert np.all(k2[:, hb[0]] > 0.75), k2
    assert np.all(e2[:, hb[0]] > 0.85), e2
    # The majority vote: the subpixel dominated by the sentinel stays
    # no-blocker; the blocker side stays blocked.
    assert not hb[0, 0] and hb[0, 3]


def test_nomination_umbra_edge_tracks_full_res():
    """A wall with a far pseudo-center light: the half-res nomination's
    visibility in the deep umbra band east of the wall must track the
    full-res walk (no lit fringe from nomination-grid artifacts)."""
    H, W = 64, 112
    obs = [LightObstruction.box((70, 32, 10), (3, 26, 10))]
    scene = pack_scene(obs, group_capacity_round=1)
    lights = jnp.asarray([[-4000.0, 32.0, 60.0]], jnp.float32)
    radii = jnp.asarray([40.0])
    ramps = jnp.asarray([4000.0])
    pz = jnp.zeros((H, W))

    vis = {}
    for s in (1.0, 0.5):
        q = QualitySettings(scan_nomination_scale=s)
        vis[s] = np.asarray(
            scan_visibility(scene, H, W, lights, radii, ramps, q,
                            trace_z=8.0, pixel_z=pz))[0]

    # Deep umbra band just east of the wall (rows near the light's y,
    # skipping the penumbra sliver at the wall itself).
    band_full = vis[1.0][26:39, 76:104]
    band_half = vis[0.5][26:39, 76:104]
    assert band_full.max() < 0.2, band_full.max()
    assert band_half.max() < 0.3, (
        "nomination upsample lit a fringe inside the umbra: "
        f"max vis {band_half.max():.3f}"
    )
    assert np.abs(band_half - band_full).mean() < 0.05


def test_begin_tick_granularity_accounting():
    from illuminant.particles.spawner import Spawner

    sp = Spawner(min_rate=610.0, max_rate=610.0, spawn_max=1024, seed=3)
    dt = 1.0 / 60.0
    total = 0
    for i in range(600):
        c = sp.begin_tick(i * dt, dt, granularity=8)
        assert c % 8 == 0
        total += c
    expect = 610.0 * 600 * dt
    assert sp.total_spawned == total
    # The rounding remainder re-enters the accumulator: long-run
    # emission tracks the exact rate within one granule.
    assert abs(total - expect) <= 8.0, (total, expect)


def test_spawn_sub_rings_overflow_falls_back_to_scatter():
    from illuminant.particles.formula import Formula1, Formula3
    from illuminant.particles.spawner import Spawner, spawn
    from illuminant.particles.state import ParticleState

    n, smax, d = 64, 128, 4  # spawn_max > capacity: windows self-overlap
    st = ParticleState.empty(n)
    u = Spawner(min_rate=0, max_rate=0, life=Formula1(constant=5.0),
                position=Formula3(constant=(1.0, 2.0, 3.0))).uniforms(0.0)
    st2 = spawn(st, u, jnp.asarray(smax, jnp.int32),
                jax.random.key(0), smax, sub_rings=d)
    # Every block fills completely (seg=32 > block=16, drop semantics).
    assert int(st2.live_count()) == n
    # Cursor advanced by the full count.
    assert int(st2.write_cursor) == smax % n


def test_system_render_consumes_config_z_fields():
    from illuminant.particles.formula import Formula1, Formula3
    from illuminant.particles.spawner import Spawner
    from illuminant.particles.system import (
        ParticleSystem, ParticleSystemConfig)
    from illuminant.raster.render import render_particles
    from illuminant.raster.tiled import TiledRasterConfig

    cfg = ParticleSystemConfig(capacity=256, z_formula=(0.0, 0.0, 1.0, 0.0),
                               size_from_z=0.25)
    sys_ = ParticleSystem(
        cfg,
        transforms=[Spawner(min_rate=600.0, max_rate=600.0, spawn_max=64,
                            life=Formula1(constant=4.0),
                            position=Formula3(constant=(8.0, 8.0, 2.0)))])
    sys_.update(1.0 / 30.0)
    # The canonical raster test shape (test_render_particles._cfg) so
    # the ordered-alpha scan compile is shared across files.
    rc = TiledRasterConfig(height=64, width=64, tile=32, bin_capacity=64,
                           rgba8_colors=False, apron=4)
    img, _ = sys_.render(rc, additive_blend=False)
    img2, _ = render_particles(sys_.state, rc, additive_blend=False,
                               z_formula=cfg.z_formula,
                               size_from_z=cfg.size_from_z)
    np.testing.assert_array_equal(np.asarray(img), np.asarray(img2))
