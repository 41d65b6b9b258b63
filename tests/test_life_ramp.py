"""ParticleColorLifeRamp + RoundingPowerFromLife parity.

Reference semantics: UpdateCommon.fxh:6-16,66-80 (life ramp texture,
POINT-sampled, U clamp / V wrap, strength lerp, negative strength
inverts U) and RasterizeParticleSystem.fx:139-156 + ParticleConfiguration
.cs:82 (RoundingPowerFromLife bezier animating computeCircularAlpha's
power).
"""

import numpy as np
import jax.numpy as jnp

from illuminant.ops.bezier import constant_bezier, pack_bezier
from illuminant.particles.render_data import (
    RenderDataUniforms,
    compute_render_data,
    pack_life_ramp_settings,
)
from illuminant.particles.state import ParticleState
from illuminant.raster.render import ParticleAppearance, render_particles
from illuminant.raster.particles import rasterize_additive
from illuminant.raster.sprites import circular_alpha
from illuminant.raster.tiled import TiledRasterConfig


def _uniforms(**kw):
    base = RenderDataUniforms.defaults()
    return base.replace(**kw)


def test_life_ramp_blend_and_addressing():
    # 3-row, 4-column ramp: row r is a flat color keyed by r, column c
    # scales by c — distinguishes U (life) from V (index) addressing.
    ramp = np.zeros((3, 4, 4), np.float32)
    for r in range(3):
        for c in range(4):
            ramp[r, c] = [0.1 * (r + 1) * (c + 1), 0.2 * (r + 1),
                          0.05 * (c + 1), 1.0]
    u = _uniforms(
        life_ramp=jnp.asarray(ramp),
        life_ramp_settings=pack_life_ramp_settings(
            strength=0.75, minimum=0.5, maximum=2.5, texture_height=3),
    )
    n = 8
    life = np.asarray([0.0, 0.4, 0.6, 1.0, 1.5, 2.4, 3.0, 9.0],
                      np.float32)
    pos = np.zeros((n, 4), np.float32)
    pos[:, 3] = life
    vel = np.zeros((n, 4), np.float32)
    attrs = np.full((n, 4), 0.8, np.float32)
    index = jnp.arange(n)
    rc, _rd = compute_render_data(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(attrs), index, u)
    rc = np.asarray(rc)

    # Hand-evaluate fxh:66-80: u = (life-0.5)/2.0 clamped by the
    # sampler; col = floor(u*4) clamped; row = index mod 3 (indexDivisor
    # = height -> v*H = index); lerp by 0.75; then attributes multiply
    # and premultiply-by-alpha (fxh:109-111).
    for i in range(n):
        if life[i] <= 0.0:
            assert np.all(rc[i] == 0.0)
            continue
        uu = (life[i] - 0.5) / 2.0
        col = int(np.clip(np.floor(uu * 4), 0, 3))
        row = i % 3
        expect = 1.0 + (ramp[row, col] * 1.0 - 1.0) * 0.75
        expect = attrs[i] * expect
        a = np.clip(expect[3], 0.0, 1.0)
        expect = np.concatenate([expect[:3] * a, [a]])
        np.testing.assert_allclose(rc[i], expect, atol=1e-5, err_msg=str(i))


def test_life_ramp_invert_flips_u():
    ramp = np.zeros((1, 4, 4), np.float32)
    ramp[0, :, 0] = [0.0, 0.25, 0.5, 1.0]
    ramp[0, :, 3] = 1.0
    base = dict(strength=1.0, minimum=0.0, maximum=4.0, texture_height=1)
    pos = np.zeros((2, 4), np.float32)
    pos[:, 3] = [0.5, 3.9]  # cols 0 and 3 (or inverted)
    vel = np.zeros((2, 4), np.float32)
    attrs = np.ones((2, 4), np.float32)
    idx = jnp.arange(2)

    u_fwd = _uniforms(life_ramp=jnp.asarray(ramp),
                      life_ramp_settings=pack_life_ramp_settings(**base))
    u_inv = _uniforms(life_ramp=jnp.asarray(ramp),
                      life_ramp_settings=pack_life_ramp_settings(
                          invert=True, **base))
    fwd, _ = compute_render_data(jnp.asarray(pos), jnp.asarray(vel),
                                 jnp.asarray(attrs), idx, u_fwd)
    inv, _ = compute_render_data(jnp.asarray(pos), jnp.asarray(vel),
                                 jnp.asarray(attrs), idx, u_inv)
    fwd, inv = np.asarray(fwd), np.asarray(inv)
    # Invert flips which life samples the bright end (fxh:73-74).
    assert fwd[0, 0] < fwd[1, 0]
    assert inv[0, 0] > inv[1, 0]
    np.testing.assert_allclose(fwd[0, 0], inv[1, 0], atol=1e-5)


def _state_with(x, y, size, life=1.0):
    n = len(x)
    cap = 64
    st = ParticleState.empty(cap)
    pos = np.zeros((cap, 4), np.float32)
    rd = np.zeros((cap, 4), np.float32)
    rc = np.zeros((cap, 4), np.float32)
    pos[:n, 0] = x
    pos[:n, 1] = y
    pos[:n, 3] = life if np.ndim(life) == 0 else life
    rd[:n, 0] = size
    rc[:n] = [0.9, 0.7, 0.5, 1.0]
    return st.replace(position=jnp.asarray(pos),
                      render_data=jnp.asarray(rd),
                      render_color=jnp.asarray(rc))


def test_rounding_power_matches_oracle_constant():
    """Constant power 0.5 through the power-disc sprite table vs the
    exact per-pixel computeCircularAlpha oracle."""
    h = w = 64
    size = 8.0
    st = _state_with([20.5, 44.5, 32.5], [20.5, 40.5, 48.5], size)
    app = ParticleAppearance(rounded=True, rounding_power_from_life=0.5,
                             size_bins=1, size_min=size, size_max=size,
                             rank=6)
    cfg = TiledRasterConfig(height=h, width=w, tile=32, bin_capacity=64,
                            apron=5, rgba8_colors=False, channels=4)
    img, _ = render_particles(st, cfg, appearance=app)
    oracle = rasterize_additive(st, h, w, footprint=11,
                                rounding_power=0.5)
    img, oracle = np.asarray(img), np.asarray(oracle)
    d = np.abs(img - oracle)
    assert d.mean() < 0.01, d.mean()
    assert d.max() < 0.2, d.max()


def test_rounding_power_animates_edge_softness():
    """Low power = wide soft edge; power -> 1 = hard disc: the bezier
    must select different profiles for different life values."""
    h = w = 64
    size = 10.0
    bez = pack_bezier([[0.15], [1.0]], min_value=0.0, max_value=1.0)
    st_young = _state_with([32.0], [32.0], size, life=0.05)  # power~0.15
    st_old = _state_with([32.0], [32.0], size, life=0.98)  # power~1.0
    app = ParticleAppearance(rounded=True, rounding_power_from_life=bez,
                             size_bins=1, size_min=size, size_max=size,
                             rank=6, power_bins=8)
    cfg = TiledRasterConfig(height=h, width=w, tile=32, bin_capacity=64,
                            apron=6, rgba8_colors=False, channels=4)
    img_soft, _ = render_particles(st_young, cfg, appearance=app)
    img_hard, _ = render_particles(st_old, cfg, appearance=app)
    img_soft, img_hard = np.asarray(img_soft), np.asarray(img_hard)
    # Sample along +x at ~0.6 r and just outside r.
    r = size * 0.5
    mid = img_soft[32, 32 + int(0.6 * r), 0], img_hard[32, 32 + int(0.6 * r), 0]
    # Soft profile has faded by 0.6r; the hard disc is still full.
    assert mid[0] < mid[1] * 0.8, mid
    # Exact curves agree: check the analytic form orders the same way.
    assert circular_alpha(0.6, 0.15) < circular_alpha(0.6, 1.0)


def test_power_disc_table_binning():
    app = ParticleAppearance(rounded=True,
                             rounding_power_from_life=pack_bezier(
                                 [[0.2], [0.9]], 0.0, 1.0),
                             power_bins=6)
    table, powers = app.power_disc_table()
    assert table.frames == 6
    assert abs(powers[0] - 0.2) < 1e-6 and abs(powers[-1] - 0.9) < 1e-6
    # Constant power collapses to one frame.
    app2 = ParticleAppearance(rounded=True, rounding_power_from_life=0.7)
    t2, p2 = app2.power_disc_table()
    assert t2.frames == 1 and p2 == (0.7,)


def test_json_binding_life_ramp_and_rounding():
    from illuminant.models.model import EngineModel
    from illuminant.models.view import EngineView

    import json

    ramp = [[[0.0, 0.5, 1.0, 1.0], [1.0, 0.5, 0.0, 1.0]]]  # (1, 2, 4)
    model = EngineModel.loads(json.dumps({
        "Systems": [{
            "Name": "s",
            "Configuration": {
                "Color": {
                    "LifeRamp": {
                        "Minimum": 0.0, "Maximum": 2.0,
                        "Strength": 0.5, "Invert": True,
                        "Texture": ramp,
                    },
                },
                "Appearance": {
                    "Rounded": True,
                    "RoundingPowerFromLife": {
                        "Count": 2, "MinValue": 0.0, "MaxValue": 1.0,
                        "A": 0.3, "B": 1.0,
                    },
                },
                "Size": 6.0,
            },
            "Transforms": [],
        }],
    }))
    view = EngineView(model)
    sv = view.systems[0]
    rd = sv.system.render_data
    assert rd.life_ramp is not None
    s = np.asarray(rd.life_ramp_settings)
    assert s[0] == -0.5  # strength * invert sign (ParticleSystem.cs:932)
    assert s[2] == 2.0  # range
    assert sv.appearance is not None
    assert sv.appearance.rounded
    table, powers = sv.appearance.power_disc_table()
    assert abs(powers[0] - 0.3) < 1e-6 and abs(powers[-1] - 1.0) < 1e-6
    # Size binds into size_from_life (SetSystemUniforms folds the base
    # Size into the bezier product's scale).
    assert float(np.asarray(rd.size_from_life.points)[0, 0]) == 6.0
