"""SVD-factored textured sprite rasterization vs numpy oracle."""

import numpy as np
import jax.numpy as jnp

from illuminant.raster.sprites import (
    SpriteTable,
    _render_variant,
    animation_frame,
    build_sprite_table,
    rasterize_sprites_jit as rasterize_sprites,
    select_bins,
)
from illuminant.raster.tiled import TiledRasterConfig


def _glow_texture(n=16):
    ys, xs = np.meshgrid(np.linspace(-1, 1, n), np.linspace(-1, 1, n),
                         indexing="ij")
    r = np.sqrt(ys ** 2 + xs ** 2)
    return np.clip(1.0 - r, 0.0, 1.0).astype(np.float32) ** 1.5


def test_variant_render_and_low_rank():
    tex = _glow_texture()
    table = build_sprite_table(tex, rank=3, size_bins=2, size_min=4.0,
                               size_max=8.0, support=11)
    assert table.row_factors.shape == (2, 3, 11)
    # Radial glows are nearly rank-3.
    assert table.residual < 0.06, table.residual
    # Factor product reconstructs the variant.
    variant = _render_variant(tex, 0.0, 8.0, 11)
    recon = np.einsum("rs,rt->st", np.asarray(table.row_factors[1]),
                      np.asarray(table.col_factors[1]))
    assert np.abs(recon - variant).max() < 0.05


def test_sprites_match_oracle():
    tex = _glow_texture()
    support = 11
    table = build_sprite_table(tex, rank=4, size_bins=3, size_min=3.0,
                               size_max=9.0, support=support)
    h = w = 96
    cfg = TiledRasterConfig(height=h, width=w, tile=32, bin_capacity=64,
                            apron=support // 2, rgba8_colors=False,
                            channels=4)
    rng = np.random.default_rng(5)
    n = 60
    # Pixel-center positions (i + 0.5) so the oracle needn't model
    # subpixel lerp: the blit below centers each variant on pixel i.
    x = (np.round(rng.uniform(8, w - 8, n)) + 0.5).astype(np.float32)
    y = (np.round(rng.uniform(8, h - 8, n)) + 0.5).astype(np.float32)
    color = rng.uniform(0.2, 1.0, (n, 4)).astype(np.float32)
    size = rng.choice([3.0, 5.196, 9.0], n).astype(np.float32)  # bins
    live = np.ones(n, bool)

    img, diag = rasterize_sprites(
        cfg, table, jnp.asarray(x), jnp.asarray(y), jnp.asarray(color),
        jnp.asarray(size), jnp.asarray(live),
    )
    img = np.asarray(img)

    # Oracle: blit each particle's exact rendered variant.
    oracle = np.zeros((h, w, 4), np.float64)
    half = support // 2
    for i in range(n):
        variant = _render_variant(tex, 0.0, size[i], support)
        iy, ix = int(y[i]) , int(x[i])
        oracle[iy - half:iy + half + 1, ix - half:ix + half + 1] += (
            variant[..., None] * color[i]
        )
    err = np.abs(img - oracle)
    scale = np.maximum(np.abs(oracle), 0.3)
    assert (err / scale).max() < 0.15, (err / scale).max()
    assert abs(img.sum() - oracle.sum()) / oracle.sum() < 0.03


def test_rotation_bins_rotate_sprite():
    # An anisotropic sprite: horizontal bar.
    tex = np.zeros((16, 16), np.float32)
    tex[6:10, 2:14] = 1.0
    table = build_sprite_table(tex, angle_bins=4, rank=4, size_bins=1,
                               size_min=10.0, size_max=10.0, support=13)
    h = w = 64
    cfg = TiledRasterConfig(height=h, width=w, tile=32, bin_capacity=16,
                            apron=6, rgba8_colors=False, channels=4)
    x = jnp.asarray([20.0, 44.0])
    y = jnp.asarray([32.0, 32.0])
    color = jnp.ones((2, 4))
    size = jnp.full((2,), 10.0)
    rot = jnp.asarray([0.0, np.pi / 2.0])
    img, _ = rasterize_sprites(cfg, table, x, y, color, size,
                               jnp.ones((2,), bool), rotation=rot)
    img = np.asarray(img)
    # Unrotated bar: wide in x. Rotated bar: tall in y.
    assert img[32, 16:25, 0].sum() > img[28:37, 20, 0].sum() * 1.5
    assert img[28:37, 44, 0].sum() > img[32, 40:49, 0].sum() * 1.5


def test_sprite_sheet_frame_selection():
    # 2-frame sheet: left frame bright, right frame dim.
    tex = np.zeros((8, 16), np.float32)
    tex[:, :8] = 1.0
    tex[:, 8:] = 0.25
    table = build_sprite_table(tex, frames_x=2, rank=2, size_bins=1,
                               size_min=6.0, size_max=6.0, support=9)
    h = w = 64
    cfg = TiledRasterConfig(height=h, width=w, tile=32, bin_capacity=16,
                            apron=4, rgba8_colors=False, channels=4)
    x = jnp.asarray([20.0, 44.0])
    y = jnp.asarray([32.0, 32.0])
    img, _ = rasterize_sprites(
        cfg, table, x, y, jnp.ones((2, 4)), jnp.full((2,), 6.0),
        jnp.ones((2,), bool), frame=jnp.asarray([0.0, 1.0]),
    )
    img = np.asarray(img)
    assert img[32, 20, 0] > img[32, 44, 0] * 2.5


def test_animation_frame_from_velocity():
    tex = np.ones((8, 32), np.float32)
    table = build_sprite_table(tex, frames_x=4, rank=1, size_bins=1,
                               support=9)
    vel = jnp.asarray([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                       [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    life = jnp.zeros((4,))
    frames = np.asarray(animation_frame(
        table, life, vel, column_from_velocity=True, frames_x=4))
    assert sorted(frames.tolist()) == [0, 1, 2, 3]


def test_sprites_alpha_matches_oracle():
    """Textured ordered-alpha: per-slot 'over'
    compositing with the sprite's factored coverage as opacity. Oracle
    composites the SAME factored variants in draw order, isolating the
    compositing logic from the (already-bounded) SVD error."""
    from illuminant.raster.sprites import rasterize_sprites_alpha_jit as rasterize_sprites_alpha

    tex = _glow_texture()
    support = 11
    table = build_sprite_table(tex, rank=4, size_bins=1, size_min=7.0,
                               size_max=7.0, support=support)
    h = w = 64
    cfg = TiledRasterConfig(height=h, width=w, tile=32, bin_capacity=64,
                            apron=support // 2, rgba8_colors=False,
                            channels=4)
    rng = np.random.default_rng(7)
    n = 40
    x = (np.round(rng.uniform(8, w - 8, n)) + 0.5).astype(np.float32)
    y = (np.round(rng.uniform(8, h - 8, n)) + 0.5).astype(np.float32)
    straight = rng.uniform(0.2, 1.0, (n, 3)).astype(np.float32)
    alpha = rng.uniform(0.3, 0.9, n).astype(np.float32)
    color = np.concatenate([straight * alpha[:, None], alpha[:, None]],
                           axis=1).astype(np.float32)  # premultiplied
    size = np.full(n, 7.0, np.float32)
    live = np.ones(n, bool)

    img, diag = rasterize_sprites_alpha(
        cfg, table, jnp.asarray(x), jnp.asarray(y), jnp.asarray(color),
        jnp.asarray(size), jnp.asarray(live),
    )
    img = np.asarray(img)
    assert int(diag["dropped"]) == 0

    # Oracle: reconstruct each variant from the factors, composite in
    # index order.
    rowf = np.asarray(table.row_factors[0], np.float64)
    colf = np.asarray(table.col_factors[0], np.float64)
    cov_v = np.clip(np.einsum("rs,rt->st", rowf, colf), 0.0, 1.0)
    oracle = np.zeros((h, w, 4), np.float64)
    half = support // 2
    for i in range(n):
        iy, ix = int(y[i]), int(x[i])
        a_eff = np.zeros((h, w))
        a_eff[iy - half:iy + half + 1, ix - half:ix + half + 1] = \
            cov_v * alpha[i]
        oracle[..., :3] = (oracle[..., :3] * (1 - a_eff[..., None])
                           + straight[i] * a_eff[..., None])
        oracle[..., 3] = oracle[..., 3] * (1 - a_eff) + a_eff
    err = np.abs(img - oracle)
    assert err.max() < 0.1, err.max()


def test_sprites_alpha_draw_order_last_on_top():
    from illuminant.raster.sprites import rasterize_sprites_alpha_jit as rasterize_sprites_alpha

    tex = np.ones((8, 8), np.float32)  # solid square sprite
    support = 9
    table = build_sprite_table(tex, rank=2, size_bins=1, size_min=6.0,
                               size_max=6.0, support=support)
    cfg = TiledRasterConfig(height=32, width=32, tile=32, bin_capacity=16,
                            apron=support // 2, rgba8_colors=False,
                            channels=4)
    # Two opaque sprites at the same position: red drawn first, then blue.
    x = jnp.asarray([16.0, 16.0])
    y = jnp.asarray([16.0, 16.0])
    color = jnp.asarray([[1, 0, 0, 1], [0, 0, 1, 1]], jnp.float32)
    size = jnp.asarray([6.0, 6.0])
    live = jnp.asarray([True, True])
    img, _ = rasterize_sprites_alpha(cfg, table, x, y, color, size, live)
    img = np.asarray(img)
    c = img[16, 16]
    assert c[2] > 0.9 and c[0] < 0.1, c  # blue (later) wins


def test_render_particles_textured_alpha_and_zformula():
    """render_particles dispatch: textured + alpha no longer raises, and
    z_formula orders compositing back-to-front (fx:101-102 screen Z)."""
    from illuminant.particles.state import ParticleState
    from illuminant.raster.render import (ParticleAppearance,
                                              render_particles)

    tex = np.ones((8, 8), np.float32)
    app = ParticleAppearance(texture=tex, size_bins=1, size_min=6.0,
                             size_max=6.0, angle_bins=1, rank=2)
    cfg = TiledRasterConfig(height=32, width=32, tile=32, bin_capacity=16,
                            apron=4, rgba8_colors=False, channels=4)
    st = ParticleState.empty(4)
    # Two overlapping particles: index 0 NEARER (z=10), index 1 FARTHER
    # (z=50). Back-to-front means index 1 composites first, so the
    # nearer red particle must win despite being EARLIER in index order.
    pos = np.zeros((4, 4), np.float32)
    pos[0] = [16, 16, 10, 1.0]  # red, near
    pos[1] = [16, 16, 50, 1.0]  # blue, far
    rc = np.zeros((4, 4), np.float32)
    rc[0] = [1, 0, 0, 1]
    rc[1] = [0, 0, 1, 1]
    rd = np.zeros((4, 4), np.float32)
    rd[:2, 0] = 6.0
    st = st.replace(position=jnp.asarray(pos),
                    render_color=jnp.asarray(rc),
                    render_data=jnp.asarray(rd))
    img, _ = render_particles(
        st, cfg, appearance=app, additive_blend=False,
        z_formula=(0.0, 0.0, 1.0, 0.0),
    )
    img = np.asarray(img)
    c = img[16, 16]
    assert c[0] > 0.9 and c[2] < 0.1, c  # near red on top

    # Without z_formula, plain draw order: later blue wins.
    img2, _ = render_particles(st, cfg, appearance=app,
                               additive_blend=False)
    c2 = np.asarray(img2)[16, 16]
    assert c2[2] > 0.9 and c2[0] < 0.1, c2


def test_size_from_z_scales_size():
    from illuminant.particles.state import ParticleState
    from illuminant.raster.render import render_particles

    cfg = TiledRasterConfig(height=32, width=32, tile=32, bin_capacity=16,
                            apron=4, rgba8_colors=False, channels=4)
    st = ParticleState.empty(2)
    pos = np.zeros((2, 4), np.float32)
    pos[0] = [8, 16, 0, 1.0]    # z=0: unscaled
    pos[1] = [24, 16, 10, 1.0]  # z=10 with size_from_z 0.5 -> 6x size
    rc = np.tile(np.asarray([1, 1, 1, 1], np.float32), (2, 1))
    rd = np.zeros((2, 4), np.float32)
    rd[:, 0] = 2.0
    st = st.replace(position=jnp.asarray(pos),
                    render_color=jnp.asarray(rc),
                    render_data=jnp.asarray(rd))
    img, _ = render_particles(st, cfg, size_from_z=0.5)
    img = np.asarray(img)
    # The scaled particle covers far more pixels.
    left = (img[:, :16, 0] > 0.01).sum()
    right = (img[:, 16:, 0] > 0.01).sum()
    assert right > left * 3, (left, right)
