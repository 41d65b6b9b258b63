"""Jump-flood 2D distance fields from masks.

The reference's JumpFlooding scene uses Squared.Render's GPU JFA
(TestGame/Scenes/JumpFlooding.cs:19,35) to build signed distance fields
from sprite silhouettes, which then feed ProcessHeightmap
(HeightFromDistance) and refraction effects.

Array form: the classic jump-flood pass reads 9 neighbours at stride k —
here each pass is 9 STATIC ROLLS of the (seed_x, seed_y, best_d2) planes
with a min-select (gather-free, fully vectorized). log2(max(H, W)) + 2
passes give the standard JFA accuracy (exact to ~1px); the result is a
SIGNED distance (negative inside the mask) compatible with
mapgen.height_from_distance.
"""

from __future__ import annotations

import math

import jax.numpy as jnp


def _flood(inside_mask):
    """One-sided JFA: distance from every pixel to the nearest masked
    pixel. Returns squared distance (H, W) f32."""
    h, w = inside_mask.shape
    big = jnp.float32(1e12)
    ys = jnp.arange(h, dtype=jnp.float32)[:, None] * jnp.ones(
        (1, w), jnp.float32)
    xs = jnp.arange(w, dtype=jnp.float32)[None, :] * jnp.ones(
        (h, 1), jnp.float32)
    seed_y = jnp.where(inside_mask, ys, -1e6)
    seed_x = jnp.where(inside_mask, xs, -1e6)
    best = jnp.where(inside_mask, 0.0, big)

    step = 1 << max(int(math.ceil(math.log2(max(h, w)))) - 1, 0)
    steps = []
    k = step
    while k >= 1:
        steps.append(k)
        k //= 2
    steps.append(1)  # JFA+1 cleanup pass

    for k in steps:
        for dy in (-k, 0, k):
            for dx in (-k, 0, k):
                if dy == 0 and dx == 0:
                    continue
                cy = jnp.roll(seed_y, (dy, dx), axis=(0, 1))
                cx = jnp.roll(seed_x, (dy, dx), axis=(0, 1))
                # Rolled-in wrap pixels carry far-away seeds (-1e6), so
                # they lose the min-select naturally.
                d2 = (cy - ys) ** 2 + (cx - xs) ** 2
                better = d2 < best
                best = jnp.where(better, d2, best)
                seed_y = jnp.where(better, cy, seed_y)
                seed_x = jnp.where(better, cx, seed_x)
    return best


def jump_flood_sdf(mask):
    """(H, W) bool/0-1 mask -> (H, W) f32 SIGNED distance (px, negative
    inside), the Squared.Render.DistanceField.JumpFlood equivalent."""
    inside = jnp.asarray(mask) > 0.5
    d_out = jnp.sqrt(_flood(inside))
    d_in = jnp.sqrt(_flood(~inside))
    return jnp.where(inside, -d_in, d_out)
