"""Windowed (bounded) light evaluation.

The reference never shades a light over the whole screen: every light
draws as an instanced quad covering just its bounds
(/root/reference/Illuminant/Lighting/LightingRenderer.cs:1149-1166 — the
VS expands per-light corner vertices, SphereLightCore.fxh:13-56), so a
small volumetric or projector light touches only its own pixels. The array
analog: cut a fixed-size window of the G-buffer around the light
(`GBuffer.window` — static shape, so one compiled kernel serves every
light position), evaluate the family core on the window, and add the
result back at the origin. Full-screen evaluation stays right for lights
whose bounds cover the frame (the flagship's sphere lights with
~0.45*max(W,H) ramps).

Sharding note (the round-3 SIGABRT): when the light centers are known at
trace time (scene constants — the common case: the reference re-uploads
light vertices per frame but a Lumined scene's volumetric/projector
placements are authored constants), the window origin resolves to PYTHON
INTS and the slice/add lower to STATIC slices. Traced-origin
`dynamic_slice`/`dynamic_update_slice` on a row-sharded lightmap lowered
to a cross-shard collective-permute whose rendezvous deadlocked XLA:CPU
(7/8 device threads arriving); static slices
take the mature halo-exchange partitioning path. The traced-origin path
remains for genuinely dynamic centers but should not cross a sharded
axis.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from jax import lax


def _concrete_f(x):
    """Python float if `x` is concrete (not a tracer), else None."""
    if isinstance(x, jax.core.Tracer):
        return None
    try:
        return float(x)
    except (TypeError, jax.errors.ConcretizationTypeError):
        return None


def window_origin(center_xy_px, win_h: int, win_w: int, height: int,
                  width: int):
    """Clamp a window centered at `center_xy_px` (pixels) into the frame.

    Returns Python ints when the center is concrete at trace time (static
    slices downstream — see module note), else traced int32 scalars."""
    cx = center_xy_px[0]
    cy = center_xy_px[1]
    cxf, cyf = _concrete_f(cx), _concrete_f(cy)
    if cxf is not None and cyf is not None:
        # float(jnp round) — not Python round — so both paths share
        # fp32 half-to-even semantics.
        ox = int(min(max(float(jnp.round(cxf - win_w * 0.5)), 0),
                     max(width - win_w, 0)))
        oy = int(min(max(float(jnp.round(cyf - win_h * 0.5)), 0),
                     max(height - win_h, 0)))
        return oy, ox
    ox = jnp.clip(jnp.round(cx - win_w * 0.5).astype(jnp.int32), 0,
                  max(width - win_w, 0))
    oy = jnp.clip(jnp.round(cy - win_h * 0.5).astype(jnp.int32), 0,
                  max(height - win_h, 0))
    return oy, ox


def add_window(lightmap, contrib, oy, ox):
    """lightmap[oy:oy+wh, ox:ox+ww, :C] += contrib (C <= lightmap's C)."""
    wh, ww, c = contrib.shape
    cl = lightmap.shape[-1]
    if c > cl:
        contrib = contrib[..., :cl]
    elif c < cl:
        contrib = jnp.concatenate(
            [contrib, jnp.zeros((wh, ww, cl - c), contrib.dtype)],
            axis=-1,
        )
    if isinstance(oy, int) and isinstance(ox, int):
        return lightmap.at[oy:oy + wh, ox:ox + ww, :].add(contrib)
    cur = lax.dynamic_slice(lightmap, (oy, ox, 0), (wh, ww, cl))
    return lax.dynamic_update_slice(lightmap, cur + contrib, (oy, ox, 0))


def window_deficit_px(support_px, win: int):
    """How many pixels of a light's support the window cannot contain:
    max(0, 2*support - win). 0 == the window fully bounds the light.
    Mirrors the tiled-light path's window_deficit_px diagnostic; the
    reference never truncates because each light's quad is sized from
    its own bounds (LightingRenderer.cs:1193-1446)."""
    return jnp.maximum(
        jnp.ceil(2.0 * jnp.asarray(support_px, jnp.float32)) - win, 0.0
    ).astype(jnp.int32)


def window_for_support(support_px: float, height: int, width: int,
                       multiple: int = 16) -> int:
    """Smallest window (multiple of `multiple`) containing a light of
    `support_px` support radius, clamped to the frame — the static
    analog of the reference sizing each light's quad from its bounds."""
    win = int(math.ceil(2.0 * float(support_px) / multiple)) * multiple
    return max(multiple, min(win, max(height, width)))


def accumulate_windowed(lightmap, gbuffer, centers_px, win: int,
                        accum_window, support_px=None):
    """Per-light bounded accumulation.

    centers_px: (L, 2) pixel centers (concrete or traced).
    `accum_window(i, gb_win)` -> (win, win, C) contribution of light i
    over the window. The Python loop over L unrolls (light capacity is
    static); each iteration is one window cut + family core + window add.

    support_px: optional (L,) per-light support radii (pixels). When
    given, returns (lightmap, deficit) where deficit (int32) is the worst
    per-light truncation in pixels (0 == every light fits its window)."""
    h, w = gbuffer.shape
    win_h = min(win, h)
    win_w = min(win, w)
    n = centers_px.shape[0]
    for i in range(n):
        oy, ox = window_origin(centers_px[i], win_h, win_w, h, w)
        gb_win = gbuffer.window(oy, ox, win_h, win_w)
        contrib = accum_window(i, gb_win)
        lightmap = add_window(lightmap, contrib.astype(lightmap.dtype),
                              oy, ox)
    if support_px is not None:
        deficit = jnp.max(window_deficit_px(support_px,
                                            min(win_h, win_w)))
        return lightmap, deficit
    return lightmap
