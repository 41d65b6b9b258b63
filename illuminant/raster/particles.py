"""Particle rasterization.

The reference renders one instanced textured quad per particle slot with
stipple/rounding/dithering (RasterizeParticleSystem.fx, SURVEY.md §3.4).

This module is the REFERENCE-EXACT scatter implementation — per-texel
circular alpha, XLA scatter-adds — kept as the correctness oracle and for
tiny systems. The production path is raster/tiled.py (sort-bin + one-hot
matmul splat) with
raster/sprites.py for textured quads; see raster/render.py for the
dispatcher. `zToY` projection (ParticleCommon.fxh getZToY) is applied like
the rasterizer's vertex path: screen y = world y - z * z_to_y.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..particles.state import ParticleState


def splat_additive(
    state: ParticleState,
    height: int,
    width: int,
    z_to_y: float = 0.0,
    render_scale: float = 1.0,
    global_color=None,
):
    """(N,) particles -> (H, W, 4) additive HDR image.

    Bilinear footprint (2x2 texels per particle). Dead and offscreen
    particles contribute nothing. Sized-quad rendering arrives with the
    tiled rasterizer; size currently modulates intensity so energy is
    conserved relative to the reference's size-2 quads.
    """
    pos = state.position
    live = state.live_mask()

    x = pos[:, 0] * render_scale
    y = (pos[:, 1] - pos[:, 2] * z_to_y) * render_scale

    color = state.render_color
    if global_color is not None:
        color = color * global_color

    tx = x - 0.5
    ty = y - 0.5
    x0 = jnp.floor(tx)
    y0 = jnp.floor(ty)
    wx = tx - x0
    wy = ty - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)

    img = jnp.zeros((height, width, 4), jnp.float32)
    for dy, dx, w in (
        (0, 0, (1 - wx) * (1 - wy)),
        (0, 1, wx * (1 - wy)),
        (1, 0, (1 - wx) * wy),
        (1, 1, wx * wy),
    ):
        xi = x0i + dx
        yi = y0i + dy
        inside = (
            live & (xi >= 0) & (xi < width) & (yi >= 0) & (yi < height)
        )
        xi = jnp.clip(xi, 0, width - 1)
        yi = jnp.clip(yi, 0, height - 1)
        contrib = color * (w * inside.astype(jnp.float32))[:, None]
        img = img.at[yi, xi].add(contrib)
    return img


def rasterize_additive(
    state: ParticleState,
    height: int,
    width: int,
    footprint: int = 5,
    z_to_y: float = 0.0,
    render_scale: float = 1.0,
    global_color=None,
    rounded: bool = True,
    stipple_factor: float = 1.0,
    size_scale: float = 1.0,
    rounding_power=None,
):
    """Sized-particle additive rasterization.

    `rounding_power`: optional per-particle (N,) (or scalar) rounding
    power — the EXACT computeCircularAlpha curve (fx:144-156) evaluated
    at the normalized disc distance, the oracle for the power-binned
    disc-table path (RoundingPowerFromLife, ParticleConfiguration.cs:82).

    The RasterizeParticleSystem.fx path for additively-blended systems:
    each live particle covers a (size x size) screen quad with circular
    rounding (`computeCircularAlpha`, fx:145-156) and stipple rejection
    (fx StippleReject). Here the quad becomes a static `footprint`^2
    scatter fan per particle (footprint odd; sizes clamp to it — raise it
    for big particles). Energy is normalized over the footprint so a
    size-s disc deposits ~s^2-proportional light like the reference quad.
    """
    pos = state.position
    live = state.live_mask()

    # Stipple (deterministic per-slot fraction, fx StippleReject).
    if stipple_factor < 1.0:
        from ..ops.coords import stipple_keep

        live = live & stipple_keep(state.capacity, stipple_factor)

    x = pos[:, 0] * render_scale
    y = (pos[:, 1] - pos[:, 2] * z_to_y) * render_scale
    size = jnp.clip(
        state.render_data[:, 0] * size_scale * render_scale,
        1.0, float(footprint),
    )
    radius = size * 0.5

    color = state.render_color
    if global_color is not None:
        color = color * global_color

    half = footprint // 2
    img = jnp.zeros((height, width, 4), jnp.float32)
    xc = jnp.floor(x).astype(jnp.int32)
    yc = jnp.floor(y).astype(jnp.int32)
    fx = x - (xc.astype(jnp.float32) + 0.5)
    fy = y - (yc.astype(jnp.float32) + 0.5)

    for dy in range(-half, half + 1):
        for dx in range(-half, half + 1):
            # Distance from the texel center to the particle center.
            ddx = dx - fx
            ddy = dy - fy
            r = jnp.sqrt(ddx * ddx + ddy * ddy)
            if rounding_power is not None:
                from .sprites import circular_alpha

                nd = r / jnp.maximum(radius, 1e-6)
                cov = circular_alpha(nd, jnp.asarray(rounding_power,
                                                     jnp.float32))
            elif rounded:
                # Soft disc edge (~computeCircularAlpha).
                cov = jnp.clip(radius - r + 0.5, 0.0, 1.0)
            else:
                cov = (
                    jnp.clip(radius - jnp.abs(ddx) + 0.5, 0.0, 1.0)
                    * jnp.clip(radius - jnp.abs(ddy) + 0.5, 0.0, 1.0)
                )
            xi = xc + dx
            yi = yc + dy
            inside = (
                live & (xi >= 0) & (xi < width)
                & (yi >= 0) & (yi < height) & (cov > 0.0)
            )
            # Like the reference quad: every covered texel adds
            # color * coverage (brightness scales with particle area).
            contrib = color * (cov * inside.astype(jnp.float32))[:, None]
            safe_x = jnp.clip(xi, 0, width - 1)
            safe_y = jnp.clip(yi, 0, height - 1)
            img = img.at[safe_y, safe_x].add(
                jnp.where(inside[:, None], contrib, 0.0)
            )
    return img
