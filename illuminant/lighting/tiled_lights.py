"""Tiled light culling: EXACT evaluation of many small lights.

The reference draws one instanced quad per particle light
(/root/reference/Illuminant/Shaders/ParticleLight.fx, instancing set up in
Particles/ParticleSystem.cs RenderLightSource) — the GPU rasterizer culls
each quad to the light's screen bounds, so 10k tiny lights cost only the
pixels they touch. The array analog of that rasterizer culling is TILED
LIGHT CULLING: partition the screen into square tiles, bin each light
into every tile its influence disc overlaps (lights have closed support:
the linear/exponential ramps reach exactly zero at radius + ramp_length),
then shade each tile against only its K binned lights as one batched
(tiles, K, tile, tile) tensor op with a matmul contraction over K for the
color sum.

Unlike the strided-subset path in particle_light.py (which samples
max_lights slots and scales brightness by the sampling ratio — mean
relative error ~0.12 at 4x subsampling), this path is exact up to the
per-tile capacity: every live particle contributes, and a `dropped`
diagnostic counts capacity overflow (0 in normal scenes).

Shadow tracing is per-light-set, not per-tile, so this path serves the
common SHADOWLESS template (ParticleLights.cs demo default); shadowed
particle lights use the subset path.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..core.pytree import named_scope
from ..sdf.analytic import scene_sample_p
from .environment import EnvironmentUniforms
from .gbuffer import GBuffer
from .sphere import (
    DOT_EXPONENT,
    DOT_OFFSET,
    DOT_RAMP_RANGE,
    _saturate,
)


def bin_lights_to_tiles(x, y, live, influence: float, tile: int,
                        th: int, tw: int, capacity: int,
                        influence_y: float | None = None,
                        tile_y_lo=None, tile_y_hi=None,
                        extra_y_window: float = 0.0):
    """Bin lights (screen px coords) into all tiles their influence
    region overlaps -> (idx (T, K) int32, mask (T, K) bool, dropped ()).

    `influence` (static, px): the light's x support radius;
    `influence_y` its y support (defaults to isotropic — pass
    influence / falloff_y_factor for squashed falloffs). The per-axis
    box test is slightly conservative vs the true ellipse (corner tiles
    bin a light that cannot reach them — capacity waste, never a miss).

    `tile_y_lo`/`tile_y_hi` ((T,) px): each tile's SHADED-WORLD y
    bounds — for 2.5D G-buffers, a pixel's world y is its screen row
    plus relative_y, so elevated tiles must widen their y interval or
    lights above structures are never binned to them. `extra_y_window`
    (static, px) sizes the candidate window for that widening.

    Each light emits (2ry+1)*(2rx+1) tile candidates; candidates sort
    by tile id and each tile gathers its first K.
    """
    n = x.shape[0]
    n_tiles = th * tw
    inf_x = float(influence)
    inf_y = inf_x if influence_y is None else float(influence_y)
    reps_x = int(np.ceil(inf_x / tile))
    reps_y = int(np.ceil((inf_y + extra_y_window) / tile))
    base_tx = jnp.floor(x / tile).astype(jnp.int32)
    base_ty = jnp.floor(y / tile).astype(jnp.int32)
    src = jnp.arange(n, dtype=jnp.int32)
    ids_list = []
    for oy in range(-reps_y, reps_y + 1):
        for ox in range(-reps_x, reps_x + 1):
            tx = base_tx + ox
            ty = base_ty + oy
            in_bounds = (tx >= 0) & (tx < tw) & (ty >= 0) & (ty < th)
            tid = jnp.where(in_bounds, ty * tw + tx, 0)
            # Closest point of the tile's world-coordinate box to the
            # light center, per axis.
            x0 = (tx * tile).astype(jnp.float32)
            if tile_y_lo is None:
                y_lo = (ty * tile).astype(jnp.float32)
                y_hi = y_lo + tile
            else:
                y_lo = tile_y_lo[tid]
                y_hi = tile_y_hi[tid]
            dx = x - jnp.clip(x, x0, x0 + tile)
            dy = y - jnp.clip(y, y_lo, y_hi)
            ok = (
                (jnp.abs(dx) <= inf_x) & (jnp.abs(dy) <= inf_y)
                & live & in_bounds
            )
            ids_list.append(jnp.where(ok, tid, n_tiles))
    m = len(ids_list)
    ids = jnp.concatenate(ids_list)
    srcs = jnp.tile(src, m)
    order = jnp.argsort(ids)
    ids_s = ids[order]
    src_s = srcs[order]
    bounds = jnp.searchsorted(
        ids_s, jnp.arange(n_tiles + 1, dtype=jnp.int32)
    )
    starts = bounds[:-1]
    ends = bounds[1:]
    slot = starts[:, None] + jnp.arange(capacity, dtype=jnp.int32)[None]
    mask = slot < ends[:, None]
    idx = src_s[jnp.minimum(slot, ids.shape[0] - 1)]
    dropped = jnp.sum(jnp.maximum(ends - starts - capacity, 0))
    return idx, mask, dropped


def _to_tiles(plane, th, tw, tile):
    """(Hp, Wp) -> (T, tile, tile)."""
    return plane.reshape(th, tile, tw, tile).transpose(0, 2, 1, 3) \
        .reshape(th * tw, tile, tile)


@named_scope("illuminant/tiled_particle_lights")
def accumulate_sphere_lights_tiled(
    volume,
    gbuffer: GBuffer,
    position,  # (N, >=3) world; column 3 (if present) = life gate
    color,  # (N, 4) un-premultiplied rgba per light
    active,  # (N,) bool
    template,  # SphereLightSource (shared radius/ramp/falloff/AO)
    env: EnvironmentUniforms,
    tile: int = 64,
    capacity: int = 32,
    with_alpha: bool = True,
    max_relative_y: float = 0.0,
    brightness_scale: float = 1.0,
):
    """Shade N template-uniform shadowless lights -> (H, W, 4) HDR add,
    plus a diagnostics dict with the capacity-overflow `dropped` count.

    Exactly accumulate_sphere_lights' shading per light
    (computeSphereLightOpacity, LightCommon.fxh:173-210; AO factored out
    per pixel since the template radius is shared) restricted to each
    light's support tiles. No specular/ramp/shadows — the particle-light
    template surface (LightSource.cs:466-505).
    """
    h, w = gbuffer.shape
    rs = gbuffer.render_scale
    th = -(-h // tile)
    tw = -(-w // tile)
    hp, wp = th * tile, tw * tile

    def pad(p, fill=0.0):
        return jnp.pad(p, ((0, hp - h), (0, wp - w)),
                       constant_values=fill)

    # Support radius in px: linear ramp ends at radius + ramp_length;
    # exponential is its square (same zero); falloff 'none' ends at
    # radius + 1 (LightCommon.fxh:197-203). +0.5 pixel-center guard.
    # The y support divides by falloff_y_factor (shading squashes d3y by
    # it, so the real reach in y is longer when the factor < 1).
    r_world = template.radius + (
        template.ramp_length if template.ramp_mode < 2 else 1.0
    )
    influence = float(r_world) * rs + 0.5
    influence_y = float(r_world) / max(template.falloff_y_factor, 1e-3) \
        * rs + 0.5

    # Per-tile SHADED-WORLD y bounds: a 2.5D pixel's world y is its
    # screen row plus relative_y, so elevated tiles widen their y
    # interval (`max_relative_y` sizes the static candidate window —
    # pass the scene's height-volume ceiling for tall relief).
    rel_t = _to_tiles(pad(gbuffer.relative_y), th, tw, tile)
    t_idx = jnp.arange(th * tw, dtype=jnp.int32)
    ty0 = ((t_idx // tw) * tile).astype(jnp.float32)
    t_ylo = ty0 + jnp.min(rel_t, axis=(1, 2)) * rs
    t_yhi = ty0 + tile + jnp.max(rel_t, axis=(1, 2)) * rs

    lx_px = position[:, 0] * rs
    ly_px = position[:, 1] * rs
    extra_y = float(max_relative_y) * rs
    idx, mask, dropped = bin_lights_to_tiles(
        lx_px, ly_px, active, influence, tile, th, tw, capacity,
        influence_y=influence_y, tile_y_lo=t_ylo, tile_y_hi=t_yhi,
        extra_y_window=extra_y,
    )
    # Relief beyond the static candidate window cannot be binned (the
    # per-tile y bounds widen validity, but candidates only enumerate
    # +-reps_y tiles) — report the deficit so callers with tall
    # height volumes know to raise max_relative_y.
    window_deficit = jnp.maximum(
        jnp.max(jnp.abs(rel_t)) * rs - extra_y, 0.0)

    # Per-tile pixel planes (T, 1, tile, tile) — world units.
    ys = (jnp.arange(hp, dtype=jnp.float32) + 0.5) / rs
    xs = (jnp.arange(wp, dtype=jnp.float32) + 0.5) / rs
    wx = _to_tiles(jnp.broadcast_to(xs[None, :], (hp, wp)), th, tw, tile)
    wy_g = jnp.broadcast_to(ys[:, None], (hp, wp)) + pad(gbuffer.relative_y)
    wy = _to_tiles(wy_g, th, tw, tile)
    wz = _to_tiles(pad(gbuffer.z), th, tw, tile)
    nx = _to_tiles(pad(gbuffer.normal[..., 0]), th, tw, tile)
    ny = _to_tiles(pad(gbuffer.normal[..., 1]), th, tw, tile)
    nz = _to_tiles(pad(gbuffer.normal[..., 2]), th, tw, tile)
    fullbright = _to_tiles(pad(gbuffer.fullbright, 1.0), th, tw, tile)
    wx = wx[:, None]
    wy = wy[:, None]
    wz = wz[:, None]

    # Gathered per-tile light attributes — all small (T, K[, c]) arrays.
    lp_all = position[idx]  # (T, K, >=3)
    on_all = mask.astype(jnp.float32) * active.astype(jnp.float32)[idx]
    t_color = jnp.asarray(template.color, jnp.float32)
    col = color[idx] * t_color  # (T, K, 4), ParticleLight.fx:40-71
    col_w = col[..., :3] * (
        col[..., 3:4] * (template.opacity * brightness_scale))
    # Column 3 accumulates raw opacity into the output alpha in the same
    # contraction.
    col4 = jnp.concatenate(
        [col_w, jnp.ones_like(col_w[..., :1])], axis=-1)

    radius = jnp.float32(template.radius)
    ramp_length = jnp.float32(max(template.ramp_length, 1e-6))
    y_factor = jnp.float32(max(template.falloff_y_factor, 1e-3))
    lo = jnp.maximum(env.light_occlusion, 1e-6)
    no_normal = (nx == 0.0) & (ny == 0.0) & (nz == 0.0)

    n_tiles_t = wx.shape[0]
    npix = tile * tile

    def chunk_contrib(sl):
        """sum over a K-chunk of color_k * opacity_k -> (T, npix, 4).

        computeSphereLightOpacity (LightCommon.fxh:173-210). Chunking
        bounds the materialized (T, kc, tile, tile) intermediates — a
        single K-wide chain holds ~270 MB at 1080p defaults, several
        times the whole frame's working set."""
        lpx = lp_all[:, sl, 0][..., None, None]
        lpy = lp_all[:, sl, 1][..., None, None]
        lpz = lp_all[:, sl, 2][..., None, None]
        on = on_all[:, sl][..., None, None]
        d3x = wx - lpx
        d3y = (wy - lpy) * y_factor
        d3z = wz - lpz
        distance = jnp.sqrt(d3x * d3x + d3y * d3y + d3z * d3z + 1e-12)
        distance_factor = 1.0 - _saturate(
            (distance - radius) / ramp_length)
        occl = 1.0 - _saturate(d3z / lo)
        distance_factor = distance_factor * jnp.where(
            env.light_occlusion > 0.0, occl, 1.0
        )
        dot = -(d3x * nx[:, None] + d3y * ny[:, None]
                + d3z * nz[:, None]) / distance
        normal_factor = _saturate(
            (dot + DOT_OFFSET) / DOT_RAMP_RANGE) ** DOT_EXPONENT
        normal_factor = jnp.where(no_normal[:, None], 1.0, normal_factor)
        if template.ramp_mode >= 2:
            distance_factor = 1.0 - _saturate(distance - radius)
            normal_factor = jnp.ones_like(normal_factor)
        elif template.ramp_mode >= 1:
            distance_factor = distance_factor * distance_factor
        opacity = _saturate(
            normal_factor * distance_factor + _saturate(radius - distance)
        ) * on
        # Matmul contraction over the chunk's light axis (colors vary per
        # light, unlike the dense path's per-set einsum).
        return jnp.einsum(
            "tkp,tkc->tpc",
            opacity.reshape(n_tiles_t, opacity.shape[1], npix)
            .astype(jnp.bfloat16),
            col4[:, sl].astype(jnp.bfloat16),
            preferred_element_type=jnp.float32,
        )

    kc = min(8, capacity)
    acc = jnp.zeros((n_tiles_t, npix, 4), jnp.float32)
    for c0 in range(0, capacity, kc):
        acc = acc + chunk_contrib(slice(c0, min(c0 + kc, capacity)))

    # Per-PIXEL factors shared by every light of the template — applied
    # once to the sum instead of per (light, pixel): fullbright discard
    # and AO (AOCommon.fxh:1-20, upward faces only).
    pix_f = (fullbright < 0.5).astype(jnp.float32)
    if template.ambient_occlusion_radius > 0.0 and volume is not None:
        ao_r = template.ambient_occlusion_radius * jnp.maximum(0.0, nz)
        d = scene_sample_p(volume, wx[:, 0], wy[:, 0],
                           wz[:, 0] + nz * ao_r)
        clamped = jnp.clip(d, 0.0, ao_r)
        r = 1.0 - _saturate(clamped / jnp.maximum(ao_r, 1e-6))
        r = 1.0 - r * r
        ao = (1.0 - template.ambient_occlusion_opacity) \
            + r * template.ambient_occlusion_opacity
        pix_f = pix_f * jnp.where(ao_r >= 0.5, ao, 1.0)
    acc = acc * pix_f.reshape(n_tiles_t, npix, 1)
    out_rgba = acc.reshape(n_tiles_t, tile, tile, 4)
    out_rgb = out_rgba[..., :3]
    out_a = out_rgba[..., 3]

    def untile(t):
        lead = t.shape[3:]
        return t.reshape((th, tw, tile, tile) + lead) \
            .transpose((0, 2, 1, 3) + tuple(range(4, 4 + len(lead)))) \
            .reshape((hp, wp) + lead)[:h, :w]

    out = jnp.concatenate(
        [untile(out_rgb), untile(out_a)[..., None]], axis=-1
    )
    if not with_alpha:
        out = out[..., :3]
    return out, dict(dropped=dropped, window_deficit_px=window_deficit)
