"""Regression tests for the round-2 review findings.

1. scan_shadows f16 k storage: the stored blocker distance must stay in
   [0, W] for far off-screen lights (directional pseudo-centers) — the
   round-2 code stored k - k_off which DOUBLED the magnitude and cost
   ~8 px of f16 quantization.
2. raster _quad_gather window: bin_capacity not divisible by
   slots_per_row must neither raise (aligned) nor silently truncate
   near-full bins (unaligned).
3. histogram custom boundaries fall back to the comparison path.
"""

import numpy as np
import jax.numpy as jnp

from illuminant.lighting.scan_shadows import _bidirectional_scan
from illuminant.raster.tiled import (
    KERNEL_QUAD,
    TiledRasterConfig,
    rasterize_tiled_jit as rasterize_tiled,
    rasterize_tiled_alpha_jit as rasterize_tiled_alpha,
)
from illuminant.utils.histogram import bucket_boundaries, \
    compute_histogram


def test_scan_k_storage_survives_f16_for_offscreen_light():
    # A vertical wall at x=100; the light 4000 px off-screen to the west
    # (the directional pseudo-center regime). The blocker distance the
    # scan records must round-trip through its f16 storage within ~1 px;
    # storing k-k_off (round-2 bug) put the stored magnitude at ~8100
    # where the f16 step is 8 px.
    H, W = 64, 256
    wall_x = 100.0
    xs = np.arange(W, dtype=np.float32) + 0.0
    occ = np.broadcast_to(
        np.abs(xs - wall_x) - 0.5, (H, W)
    ).astype(np.float32)

    lx = jnp.asarray([-4000.0])
    ly = jnp.asarray([32.0])
    lr = jnp.asarray([8.0])
    (e_d, e_k, _e_n), _west = _bidirectional_scan(
        jnp.asarray(occ), lx, ly, lr, unroll=1
    )
    e_k = np.asarray(e_k, np.float32)[0]  # (H, W)
    # Readout contract (scan_visibility): true k = stored - k_off.
    k_off = min(float(lx[0]), 0.0)
    true_k = e_k - k_off
    # Columns well behind the wall: every row's min is at the wall,
    # dx = wall_x - lx = 4100.
    region = true_k[:, 120:250]
    err = np.abs(region - (wall_x - float(lx[0])))
    assert err.max() < 1.0, f"f16 k round-trip error {err.max()} px"


def _profile_np_quad(d, radius):
    return np.clip(radius - np.abs(d) + 0.5, 0.0, 1.0)


def _oracle_additive(cfg, x, y, color, size, live):
    img = np.zeros((cfg.height, cfg.width, 4), np.float64)
    ys = np.arange(cfg.height) + 0.5
    xs = np.arange(cfg.width) + 0.5
    for i in range(len(x)):
        if not live[i]:
            continue
        r = np.clip(size[i] * 0.5, 0.5, cfg.apron + 0.5)
        wy = _profile_np_quad(ys - y[i], r)
        wx = _profile_np_quad(xs - x[i], r)
        img += (wy[:, None] * wx[None, :])[..., None] * color[i]
    return img


def _near_full_bins(h, w, tile, per_tile, seed=11):
    # per_tile particles dropped inside each tile's interior (no apron
    # spill) so every bin count is exactly per_tile.
    rng = np.random.default_rng(seed)
    gx, gy = w // tile, h // tile
    xs, ys = [], []
    for ty in range(gy):
        for tx in range(gx):
            xs.append(rng.uniform(tx * tile + 6, (tx + 1) * tile - 6,
                                  per_tile))
            ys.append(rng.uniform(ty * tile + 6, (ty + 1) * tile - 6,
                                  per_tile))
    x = np.round(np.concatenate(xs) * 16) / 16
    y = np.round(np.concatenate(ys) * 16) / 16
    n = x.shape[0]
    color = rng.uniform(0.2, 1.0, (n, 4)).astype(np.float32)
    size = rng.uniform(1.0, 4.0, n).astype(np.float32)
    live = np.ones(n, bool)
    return (x.astype(np.float32), y.astype(np.float32), color, size,
            live)


def test_quad_gather_capacity_not_multiple_of_spr_additive():
    # k=24, spr=16: k % spr == 8 — the round-2 window (k//spr + 1 rows =
    # 32 slots) under-covered off + k for off > 8, silently truncating
    # the tail of near-full bins.
    h, w, tile = 64, 64, 32
    cfg = TiledRasterConfig(height=h, width=w, tile=tile,
                            bin_capacity=24, slots_per_row=16,
                            apron=4, kernel=KERNEL_QUAD,
                            rgba8_colors=False)
    x, y, color, size, live = _near_full_bins(h, w, tile, per_tile=23)
    img, diag = rasterize_tiled(cfg, jnp.asarray(x), jnp.asarray(y),
                                jnp.asarray(color), jnp.asarray(size),
                                jnp.asarray(live))
    assert int(diag["dropped"]) == 0
    oracle = _oracle_additive(cfg, x, y, color, size, live)
    img = np.asarray(img, np.float64)
    # A truncated tail loses whole particles — energy check catches it.
    assert abs(img.sum() - oracle.sum()) / oracle.sum() < 0.02
    scale = np.maximum(np.abs(oracle), 0.25)
    assert (np.abs(img - oracle) / scale).max() < 0.08


def test_quad_gather_capacity_not_multiple_of_spr_alpha():
    # Aligned mode raised a broadcast ValueError at trace time in round 2.
    h, w, tile = 64, 64, 32
    cfg = TiledRasterConfig(height=h, width=w, tile=tile,
                            bin_capacity=24, slots_per_row=16,
                            apron=4, kernel=KERNEL_QUAD,
                            rgba8_colors=False)
    x, y, color, size, live = _near_full_bins(h, w, tile, per_tile=23)
    img, diag = rasterize_tiled_alpha(
        cfg, jnp.asarray(x), jnp.asarray(y), jnp.asarray(color),
        jnp.asarray(size), jnp.asarray(live)
    )
    assert int(diag["dropped"]) == 0
    assert np.isfinite(np.asarray(img)).all()


def test_histogram_custom_boundaries_comparison_path():
    lum = np.linspace(0.0, 10.0, 512, dtype=np.float32)
    img = np.repeat(lum[:, None], 4, axis=1).reshape(8, 64, 4)
    # Linear boundaries — NOT the analytic log spacing.
    bounds = np.linspace(0.5, 12.0, 16, dtype=np.float32)
    res = compute_histogram(jnp.asarray(img), bounds)
    counts = np.asarray(res.counts)
    # Oracle: bucket i takes values < bounds[i] (first below its max,
    # last takes the rest).
    idx = np.clip(np.searchsorted(bounds, lum, side="right"), 0, 15)
    oracle = np.bincount(idx, minlength=16)
    np.testing.assert_array_equal(counts, oracle)
    # And the analytic path still matches itself.
    b2 = bucket_boundaries(64.0, 2.0, 64)
    res2 = compute_histogram(jnp.asarray(img), b2)
    assert int(np.asarray(res2.counts).sum()) == lum.size
