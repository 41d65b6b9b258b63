"""Tiled rasterizer vs brute-force numpy oracle."""

import numpy as np
import jax.numpy as jnp

from illuminant.raster.tiled import (
    KERNEL_GAUSS,
    KERNEL_POINT,
    KERNEL_QUAD,
    TiledRasterConfig,
    rasterize_tiled_jit as rasterize_tiled,
    rasterize_tiled_alpha_jit as rasterize_tiled_alpha,
)


def _profile_np(kernel, d, radius):
    if kernel == KERNEL_POINT:
        return np.clip(1.0 - np.abs(d), 0.0, 1.0)
    if kernel == KERNEL_QUAD:
        return np.clip(radius - np.abs(d) + 0.5, 0.0, 1.0)
    if kernel == KERNEL_GAUSS:
        # (1 - q/8)^8 squaring-chain gaussian — mirrors raster/tiled.py
        sigma = max(radius * 0.5, 0.3)
        q = 0.5 * (d / sigma) ** 2
        return np.maximum(1.0 - q * 0.125, 0.0) ** 8
    raise ValueError(kernel)


def _oracle_additive(cfg, x, y, color, size, live):
    img = np.zeros((cfg.height, cfg.width, 4), np.float64)
    ys = np.arange(cfg.height) + 0.5
    xs = np.arange(cfg.width) + 0.5
    for i in range(len(x)):
        if not live[i]:
            continue
        r = np.clip(size[i] * 0.5, 0.5, cfg.apron + 0.5)
        wy = _profile_np(cfg.kernel, ys - y[i], r)
        wx = _profile_np(cfg.kernel, xs - x[i], r)
        img += (wy[:, None] * wx[None, :])[..., None] * color[i]
    return img


def _random_particles(n, h, w, seed=0, hdr=2.0):
    rng = np.random.default_rng(seed)
    # Positions pre-quantized to the rasterizer's 1/16-px payload grid so
    # the oracle sees identical coordinates (quantize_xy contract).
    x = np.round(rng.uniform(-2, w + 2, n) * 16.0).astype(np.float32) / 16
    y = np.round(rng.uniform(-2, h + 2, n) * 16.0).astype(np.float32) / 16
    color = rng.uniform(0.0, hdr, (n, 4)).astype(np.float32)
    size = rng.uniform(1.0, 7.0, n).astype(np.float32)
    live = rng.uniform(size=n) > 0.1
    return x, y, color, size, live


def test_additive_matches_oracle_quad():
    h, w, n = 64, 96, 400
    cfg = TiledRasterConfig(height=h, width=w, tile=32, bin_capacity=256,
                            apron=4, kernel=KERNEL_QUAD,
                            rgba8_colors=False)
    x, y, color, size, live = _random_particles(n, h, w)
    img, diag = rasterize_tiled(cfg, jnp.asarray(x), jnp.asarray(y),
                                jnp.asarray(color), jnp.asarray(size),
                                jnp.asarray(live))
    assert int(diag["dropped"]) == 0
    oracle = _oracle_additive(cfg, x, y, color, size, live)
    img = np.asarray(img, np.float64)
    # bf16 einsum + bf16 payload packing tolerance, relative to the
    # local magnitude.
    scale = np.maximum(np.abs(oracle), 0.25)
    rel = np.abs(img - oracle) / scale
    assert rel.max() < 0.08, rel.max()
    # Total energy matches closely.
    assert abs(img.sum() - oracle.sum()) / oracle.sum() < 0.01


def test_additive_matches_oracle_gauss_rgba8():
    h, w, n = 96, 64, 1500
    cfg = TiledRasterConfig(height=h, width=w, tile=32, bin_capacity=1024,
                            apron=4, kernel=KERNEL_GAUSS,
                            rgba8_colors=True, color_scale=2.0)
    x, y, color, size, live = _random_particles(n, h, w, seed=3)
    img, diag = rasterize_tiled(cfg, jnp.asarray(x), jnp.asarray(y),
                                jnp.asarray(color), jnp.asarray(size),
                                jnp.asarray(live))
    assert int(diag["dropped"]) == 0
    oracle = _oracle_additive(cfg, x, y, color, size, live)
    img = np.asarray(img, np.float64)
    # rgba8 quantization: 2/255 per particle; ~dozens overlap per texel.
    scale = np.maximum(np.abs(oracle), 0.5)
    rel = np.abs(img - oracle) / scale
    assert rel.max() < 0.12, rel.max()
    assert abs(img.sum() - oracle.sum()) / oracle.sum() < 0.02


def test_bin_overflow_counts_drops():
    h = w = 32
    n = 300
    cfg = TiledRasterConfig(height=h, width=w, tile=32, bin_capacity=256,
                            apron=2, kernel=KERNEL_POINT,
                            rgba8_colors=False, overflow_tiles=0)
    x = jnp.full((n,), 16.0)
    y = jnp.full((n,), 16.0)
    color = jnp.ones((n, 4))
    size = jnp.ones((n,))
    live = jnp.ones((n,), bool)
    img, diag = rasterize_tiled(cfg, x, y, color, size, live)
    assert int(diag["dropped"]) == n - 256
    # The kept 256 still render.
    assert float(img[16, 16, 0]) > 1.0


def test_hierarchical_overflow_recovers_hot_tile():
    h = w = 64
    n = 600  # one hot tile at 2.3x bin capacity
    cfg = TiledRasterConfig(height=h, width=w, tile=32, bin_capacity=256,
                            apron=2, kernel=KERNEL_POINT,
                            rgba8_colors=False, overflow_tiles=4)
    x = jnp.concatenate([jnp.full((500,), 16.0), jnp.full((100,), 48.0)])
    y = jnp.full((n,), 16.0)
    color = jnp.ones((n, 4))
    size = jnp.ones((n,))
    live = jnp.ones((n,), bool)
    img, diag = rasterize_tiled(cfg, x, y, color, size, live)
    assert int(diag["dropped"]) == 0
    img = np.asarray(img)
    # Full energy: every particle deposits exactly its color.
    np.testing.assert_allclose(img[..., 0].sum(), n, rtol=0.02)
    # Bilinear point splat spreads each particle over a 2x2 block.
    np.testing.assert_allclose(img[15:17, 15:17, 0].sum(), 500.0,
                               rtol=0.02)
    np.testing.assert_allclose(img[15:17, 47:49, 0].sum(), 100.0,
                               rtol=0.02)


def test_point_kernel_conserves_energy():
    h, w, n = 48, 48, 200
    cfg = TiledRasterConfig(height=h, width=w, tile=16, bin_capacity=128,
                            apron=2, kernel=KERNEL_POINT,
                            rgba8_colors=False)
    rng = np.random.default_rng(7)
    # Keep everything interior so nothing clips.
    x = rng.uniform(4, w - 4, n).astype(np.float32)
    y = rng.uniform(4, h - 4, n).astype(np.float32)
    color = rng.uniform(0.2, 1.0, (n, 4)).astype(np.float32)
    size = np.ones(n, np.float32)
    img, _ = rasterize_tiled(cfg, jnp.asarray(x), jnp.asarray(y),
                             jnp.asarray(color), jnp.asarray(size),
                             jnp.ones((n,), bool))
    # Bilinear point splat deposits exactly its color in total.
    np.testing.assert_allclose(
        np.asarray(img).sum(axis=(0, 1)), color.sum(axis=0), rtol=0.02
    )


def test_stipple_fraction():
    h, w, n = 32, 32, 1000
    cfg = TiledRasterConfig(height=h, width=w, tile=32, bin_capacity=1024,
                            apron=2, kernel=KERNEL_POINT,
                            rgba8_colors=False)
    x = jnp.full((n,), 16.0)
    y = jnp.full((n,), 16.0)
    color = jnp.ones((n, 4))
    size = jnp.ones((n,))
    live = jnp.ones((n,), bool)
    full, _ = rasterize_tiled(cfg, x, y, color, size, live)
    half, _ = rasterize_tiled(cfg, x, y, color, size, live,
                              stipple_factor=0.5)
    ratio = float(half.sum() / full.sum())
    assert 0.45 < ratio < 0.55, ratio


def test_alpha_ordering_last_on_top():
    h = w = 32
    cfg = TiledRasterConfig(height=h, width=w, tile=32, bin_capacity=16,
                            apron=4, kernel=KERNEL_QUAD,
                            rgba8_colors=False)
    # Two fully-opaque overlapping quads; slot 1 drawn after slot 0.
    x = jnp.asarray([16.0, 16.0])
    y = jnp.asarray([16.0, 16.0])
    color = jnp.asarray([[1.0, 0.0, 0.0, 1.0], [0.0, 1.0, 0.0, 1.0]])
    size = jnp.asarray([8.0, 8.0])
    live = jnp.ones((2,), bool)
    img, _ = rasterize_tiled_alpha(cfg, x, y, color, size, live)
    img = np.asarray(img)
    assert img[16, 16, 1] > 0.9 and img[16, 16, 0] < 0.1


def test_alpha_over_background():
    h = w = 32
    cfg = TiledRasterConfig(height=h, width=w, tile=32, bin_capacity=16,
                            apron=4, kernel=KERNEL_QUAD,
                            rgba8_colors=False)
    x = jnp.asarray([16.0])
    y = jnp.asarray([16.0])
    color = jnp.asarray([[0.5, 0.0, 0.0, 0.5]])  # premultiplied, a=0.5
    size = jnp.asarray([6.0])
    bg = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0, 1.0]), (h, w, 4))
    img, _ = rasterize_tiled_alpha(cfg, x, y, color, size,
                                   jnp.ones((1,), bool), background=bg)
    img = np.asarray(img)
    # Center: 50% red over blue.
    np.testing.assert_allclose(img[16, 16, :3], [0.5, 0.0, 0.5],
                               atol=0.05)
    # Far corner: untouched background.
    np.testing.assert_allclose(img[2, 2, :3], [0.0, 0.0, 1.0], atol=1e-5)


def test_dithered_opacity_is_binary():
    h = w = 32
    cfg = TiledRasterConfig(height=h, width=w, tile=32, bin_capacity=16,
                            apron=4, kernel=KERNEL_QUAD,
                            rgba8_colors=False)
    x = jnp.asarray([16.0])
    y = jnp.asarray([16.0])
    color = jnp.asarray([[0.5, 0.5, 0.5, 0.5]])
    size = jnp.asarray([12.0])
    img, _ = rasterize_tiled_alpha(cfg, x, y, color, size,
                                   jnp.ones((1,), bool), dither=True)
    a = np.asarray(img[..., 3])
    # size 12 clamps to radius apron+0.5 = 4.5 -> full coverage |d| < 4.
    inside = a[13:20, 13:20]
    # Dithering makes alpha binary with ~50% duty inside the quad core.
    assert set(np.round(np.unique(inside), 5)) <= {0.0, 1.0}
    assert 0.3 < inside.mean() < 0.7


def test_compact_payload_matches_full():
    h, w, n = 96, 64, 800
    base = dict(height=h, width=w, tile=32, bin_capacity=256, apron=4,
                kernel=KERNEL_GAUSS, rgba8_colors=True, color_scale=2.0,
                channels=3)
    rng = np.random.default_rng(11)
    # 1/8-px grid positions and bin-exact sizes so only the documented
    # quantization differs.
    x = np.round(rng.uniform(4, w - 4, n) * 8).astype(np.float32) / 8
    y = np.round(rng.uniform(4, h - 4, n) * 8).astype(np.float32) / 8
    color = rng.uniform(0.1, 1.5, (n, 4)).astype(np.float32)
    size = rng.uniform(1.0, 6.0, n).astype(np.float32)
    live = np.ones(n, bool)
    full_cfg = TiledRasterConfig(**base)
    comp_cfg = TiledRasterConfig(**base, compact_payload=True)
    a, _ = rasterize_tiled(full_cfg, jnp.asarray(x), jnp.asarray(y),
                           jnp.asarray(color), jnp.asarray(size),
                           jnp.asarray(live))
    b, _ = rasterize_tiled(comp_cfg, jnp.asarray(x), jnp.asarray(y),
                           jnp.asarray(color), jnp.asarray(size),
                           jnp.asarray(live))
    a = np.asarray(a)
    b = np.asarray(b)
    # Size quantizes to 16 log steps (<= ~15% radius step); energy and
    # structure must agree closely.
    assert abs(a.sum() - b.sum()) / a.sum() < 0.08
    corr = np.corrcoef(a.reshape(-1), b.reshape(-1))[0, 1]
    assert corr > 0.99, corr


def test_int8_splat_matches_oracle():
    """int8 matmul splat (TiledRasterConfig.int8_splat): coverage in 1/127
    steps, colors in color_scale/127 steps — additive sums stay within
    a slightly wider tolerance than the bf16 path."""
    h, w, n = 96, 64, 1500
    cfg = TiledRasterConfig(height=h, width=w, tile=32, bin_capacity=1024,
                            apron=4, kernel=KERNEL_GAUSS,
                            rgba8_colors=True, color_scale=2.0,
                            int8_splat=True)
    x, y, color, size, live = _random_particles(n, h, w, seed=3)
    img, diag = rasterize_tiled(cfg, jnp.asarray(x), jnp.asarray(y),
                                jnp.asarray(color), jnp.asarray(size),
                                jnp.asarray(live))
    assert int(diag["dropped"]) == 0
    oracle = _oracle_additive(cfg, x, y, color, size, live)
    img = np.asarray(img, np.float64)
    scale = np.maximum(np.abs(oracle), 0.5)
    rel = np.abs(img - oracle) / scale
    assert rel.max() < 0.2, rel.max()
    assert abs(img.sum() - oracle.sum()) / oracle.sum() < 0.04


def test_round_kernel_matches_exact_circular_profile():
    """KERNEL_ROUND (the parity preset's disc): the shipped quadratic
    approximation of sqrt(1 - edge^2/2) must track the exact separable
    profile (max poly error 9.7e-4, under 1/4 LSB of 8-bit coverage)."""
    from illuminant.raster.tiled import KERNEL_ROUND

    def exact_profile(d, radius):
        t = np.clip(radius - np.abs(d) + 0.5, 0.0, 1.0)
        edge = np.clip(np.abs(d) / max(radius, 0.5), 0.0, 1.0)
        return t * np.sqrt(np.maximum(1.0 - edge * edge * 0.5, 0.0))

    h, w, n = 64, 96, 400
    cfg = TiledRasterConfig(height=h, width=w, tile=32, bin_capacity=256,
                            apron=4, kernel=KERNEL_ROUND,
                            rgba8_colors=False, channels=3)
    x, y, color, size, live = _random_particles(n, h, w, seed=11)
    img, diag = rasterize_tiled(cfg, jnp.asarray(x), jnp.asarray(y),
                                jnp.asarray(color), jnp.asarray(size),
                                jnp.asarray(live))
    assert int(diag["dropped"]) == 0
    # numpy oracle with the EXACT sqrt profile
    ys = np.arange(h) + 0.5
    xs = np.arange(w) + 0.5
    oracle = np.zeros((h, w, 3), np.float64)
    for i in range(n):
        if not live[i]:
            continue
        r = float(np.clip(size[i] * 0.5, 0.5, cfg.apron + 0.5))
        wy = exact_profile(ys - y[i], r)
        wx = exact_profile(xs - x[i], r)
        oracle += (wy[:, None] * wx[None, :])[..., None] * color[i, :3]
    img = np.asarray(img, np.float64)
    scale = np.maximum(np.abs(oracle), 0.25)
    rel = np.abs(img - oracle) / scale
    assert rel.max() < 0.08, rel.max()
    assert abs(img.sum() - oracle.sum()) / oracle.sum() < 0.01


def test_channels3_bf16_payload_matches_rgba_layout():
    """channels=3 + rgba8_colors=False packs (b, size) in one operand
    (3 sort operands instead of 4 — the parity raster layout); the
    rendered rgb must equal the 4-channel bf16 layout's rgb exactly."""
    h, w, n = 64, 96, 500
    x, y, color, size, live = _random_particles(n, h, w, seed=5)
    args = (jnp.asarray(x), jnp.asarray(y), jnp.asarray(color),
            jnp.asarray(size), jnp.asarray(live))
    cfg3 = TiledRasterConfig(height=h, width=w, tile=32,
                             bin_capacity=256, apron=4,
                             kernel=KERNEL_QUAD, rgba8_colors=False,
                             channels=3)
    cfg4 = TiledRasterConfig(height=h, width=w, tile=32,
                             bin_capacity=256, apron=4,
                             kernel=KERNEL_QUAD, rgba8_colors=False,
                             channels=4)
    img3, d3 = rasterize_tiled(cfg3, *args)
    img4, d4 = rasterize_tiled(cfg4, *args)
    assert int(d3["dropped"]) == 0 and int(d4["dropped"]) == 0
    np.testing.assert_allclose(np.asarray(img3), np.asarray(img4[..., :3]),
                               rtol=0, atol=1e-5)


def test_additive_fuzz_random_configs():
    """Seeded sweep over the config lattice (tile, slots_per_row,
    kernel, payload format, channels, overflow) — each combo must match
    the oracle within its payload tolerance with zero drops."""
    rng = np.random.default_rng(99)
    combos = [
        dict(tile=16, slots_per_row=4, kernel=KERNEL_POINT,
             rgba8_colors=False, channels=4, overflow_tiles=0),
        dict(tile=32, slots_per_row=8, kernel=KERNEL_QUAD,
             rgba8_colors=True, color_scale=3.0, channels=3,
             overflow_tiles=0),
        dict(tile=32, slots_per_row=4, kernel=KERNEL_GAUSS,
             rgba8_colors=False, channels=4, overflow_tiles=16),
        dict(tile=16, slots_per_row=8, kernel=KERNEL_GAUSS,
             rgba8_colors=True, color_scale=2.0, channels=4,
             overflow_tiles=8),
    ]
    h, w = 64, 64
    for i, kw in enumerate(combos):
        n = int(rng.integers(100, 600))
        cfg = TiledRasterConfig(height=h, width=w, bin_capacity=512,
                                apron=4, **kw)
        x, y, color, size, live = _random_particles(n, h, w, seed=100 + i)
        img, diag = rasterize_tiled(cfg, jnp.asarray(x), jnp.asarray(y),
                                    jnp.asarray(color), jnp.asarray(size),
                                    jnp.asarray(live))
        assert int(diag["dropped"]) == 0, (i, kw)
        oracle = _oracle_additive(cfg, x, y, color, size, live)
        ch = kw.get("channels", 4)
        img = np.asarray(img, np.float64)
        tol = 0.12 if kw.get("rgba8_colors") else 0.08
        scale = np.maximum(np.abs(oracle[..., :ch]), 0.5)
        rel = np.abs(img[..., :ch] - oracle[..., :ch]) / scale
        assert rel.max() < tol, (i, kw, rel.max())
        assert abs(img[..., :ch].sum() - oracle[..., :ch].sum()) \
            / oracle[..., :ch].sum() < 0.02, (i, kw)


def test_clustered_drops_accounted_energy_bounded():
    """When clustering exceeds bin capacity + overflow, the dropped
    count is reported and rendered energy never exceeds the oracle's."""
    h, w, n = 64, 64, 2000
    cfg = TiledRasterConfig(height=h, width=w, tile=32, bin_capacity=256,
                            apron=4, kernel=KERNEL_QUAD,
                            rgba8_colors=False, overflow_tiles=0)
    rng = np.random.default_rng(7)
    x = np.round(rng.uniform(20, 28, n) * 16).astype(np.float32) / 16
    y = np.round(rng.uniform(20, 28, n) * 16).astype(np.float32) / 16
    color = rng.uniform(0.1, 1.0, (n, 4)).astype(np.float32)
    size = np.full(n, 3.0, np.float32)
    live = np.ones(n, bool)
    img, diag = rasterize_tiled(cfg, jnp.asarray(x), jnp.asarray(y),
                                jnp.asarray(color), jnp.asarray(size),
                                jnp.asarray(live))
    dropped = int(diag["dropped"])
    assert dropped > 0
    oracle = _oracle_additive(cfg, x, y, color, size, live)
    img = np.asarray(img, np.float64)
    assert img.sum() <= oracle.sum() * 1.01
    # Rendered energy ~ (kept / total) of the oracle's.
    kept_frac = (n - dropped) / n
    assert img.sum() >= oracle.sum() * kept_frac * 0.9


def _oracle_over(cfg, x, y, color, size, live, background=None,
                 opacity=1.0):
    """Draw-order 'over' compositor (premultiplied color input)."""
    img = np.zeros((cfg.height, cfg.width, 4), np.float64)
    ys = np.arange(cfg.height) + 0.5
    xs = np.arange(cfg.width) + 0.5
    for i in range(len(x)):
        if not live[i]:
            continue
        r = np.clip(size[i] * 0.5, 0.5, cfg.apron + 0.5)
        wy = _profile_np(cfg.kernel, ys - y[i], r)
        wx = _profile_np(cfg.kernel, xs - x[i], r)
        a_eff = (wy[:, None] * wx[None, :]) * color[i, 3] * opacity
        src_rgb = color[i, :3] / max(color[i, 3], 1e-6)
        img[..., :3] = (img[..., :3] * (1 - a_eff[..., None])
                        + src_rgb[None, None] * a_eff[..., None])
        img[..., 3] = img[..., 3] * (1 - a_eff) + a_eff
    if background is not None:
        a = np.clip(img[..., 3:4], 0, 1)
        img = np.concatenate(
            [img[..., :3] + background[..., :3] * (1 - a),
             a + background[..., 3:4] * (1 - a)], axis=-1)
    return img


def test_alpha_cross_tile_overlap_matches_oracle():
    """Particles in ADJACENT tiles whose footprints overlap must
    'over'-composite, not add (pre-fix: each tile composited its own
    window independently and the apron overlap summed, roughly doubling
    brightness at cross-tile overlaps)."""
    h, w = 64, 96
    cfg = TiledRasterConfig(height=h, width=w, tile=32, bin_capacity=64,
                            apron=4, kernel=KERNEL_QUAD,
                            rgba8_colors=False, channels=4)
    # Opaque pairs straddling every tile boundary + a random cloud.
    xs_ = [29.0, 33.0, 61.0, 66.0, 31.5, 32.5]
    ys_ = [16.0, 16.0, 40.0, 40.0, 33.0, 31.0]
    rng = np.random.default_rng(21)
    xs_ += list(np.round(rng.uniform(0, w, 40) * 16) / 16)
    ys_ += list(np.round(rng.uniform(0, h, 40) * 16) / 16)
    n = len(xs_)
    x = np.asarray(xs_, np.float32)
    y = np.asarray(ys_, np.float32)
    color = np.zeros((n, 4), np.float32)
    color[:, 3] = rng.uniform(0.5, 1.0, n)
    color[:, :3] = rng.uniform(0.2, 1.0, (n, 3)) * color[:, 3:4]
    size = np.full(n, 6.0, np.float32)
    live = np.ones(n, bool)
    img, diag = rasterize_tiled_alpha(
        cfg, jnp.asarray(x), jnp.asarray(y), jnp.asarray(color),
        jnp.asarray(size), jnp.asarray(live))
    assert int(diag["dropped"]) == 0
    oracle = _oracle_over(cfg, x, y, color, size, live)
    d = np.abs(np.asarray(img, np.float64) - oracle)
    assert d.max() < 5e-3, d.max()
    # Accumulated alpha must stay <= 1 (summing overlaps exceeded it).
    assert np.asarray(img)[..., 3].max() <= 1.0 + 1e-5


def test_alpha_background_and_opacity():
    """Premultiplied-over background alpha (a + bg_a*(1-a), not max) and
    the global opacity multiplier."""
    h, w = 32, 32
    cfg = TiledRasterConfig(height=h, width=w, tile=32, bin_capacity=16,
                            apron=4, kernel=KERNEL_QUAD,
                            rgba8_colors=False, channels=4)
    x = np.asarray([16.0], np.float32)
    y = np.asarray([16.0], np.float32)
    color = np.asarray([[0.8, 0.4, 0.2, 0.8]], np.float32)
    size = np.asarray([8.0], np.float32)
    live = np.ones(1, bool)
    bg = np.full((h, w, 4), 0.5, np.float32)
    img, _ = rasterize_tiled_alpha(
        cfg, jnp.asarray(x), jnp.asarray(y), jnp.asarray(color),
        jnp.asarray(size), jnp.asarray(live),
        background=jnp.asarray(bg), opacity=0.5)
    oracle = _oracle_over(cfg, x, y, color, size, live, background=bg,
                          opacity=0.5)
    d = np.abs(np.asarray(img, np.float64) - oracle)
    assert d.max() < 5e-3, d.max()
