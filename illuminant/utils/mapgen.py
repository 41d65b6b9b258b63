"""Map-generation tooling (the GenerateMaps editor scene).

normals_from_lightmaps ports /root/reference/Illuminant/Shaders/
ProcessNormals.fx (NormalsFromLightmaps): four lightmaps captured with a
light to the left/right/above/below of the subject become a tangent-space
normal map — n = normalize(right - left, below - above, forward) with the
input normalization window and dead-pixel detection (:52-100). Pure
elementwise math.
"""

from __future__ import annotations

import jax.numpy as jnp


def _clean_input(value, input_min, input_max, shadows_only):
    result = (value - input_min) / jnp.maximum(input_max - input_min, 1e-6)
    if shadows_only:
        result = result - 0.5
    return jnp.clip(result, 0.0, 1.0)


def normals_from_lightmaps(
    left,
    right,
    above,
    below,
    input_min: float = 0.0,
    input_max: float = 1.0,
    forward_scale: float = 1.0,
    forward_bias: float = 0.0,
    shadows_only: bool = False,
):
    """Four (H, W) luminance lightmaps -> (H, W, 4) encoded normal map.

    Dead pixels (all four inputs dark, ProcessNormals.fx:94-97) encode as
    (0, 0, 0, 1); everything else as normal * 0.5 + 0.5 (:156-159).
    """
    l = _clean_input(left, input_min, input_max, shadows_only)
    r = _clean_input(right, input_min, input_max, shadows_only)
    a = _clean_input(above, input_min, input_max, shadows_only)
    b = _clean_input(below, input_min, input_max, shadows_only)

    x_delta = r - l
    y_delta = b - a
    xy_len = jnp.sqrt(x_delta * x_delta + y_delta * y_delta)
    forward = jnp.where(
        xy_len <= 0.01,
        1.0,
        jnp.where(
            xy_len >= 0.98, 0.0, jnp.sqrt(jnp.maximum(1.0 - xy_len, 0.0))
        ),
    ) * forward_scale

    n = jnp.stack([x_delta, y_delta, forward + forward_bias], axis=-1)
    norm = jnp.sqrt(jnp.maximum(jnp.sum(n * n, axis=-1, keepdims=True),
                                1e-12))
    n = n / norm

    dead = (l <= 0.01) & (r <= 0.01) & (a <= 0.01) & (b <= 0.01)
    encoded = n * 0.5 + 0.5
    encoded = jnp.where(dead[..., None], 0.0, encoded)
    alpha = jnp.ones(encoded.shape[:-1] + (1,), jnp.float32)
    return jnp.concatenate([encoded, alpha], axis=-1)


# --- ProcessHeightmap.fx / ProcessHeightmap.fxh ---------------------------


def _synthesize_alpha(value):
    """ProcessHeightmap.fxh synthesizeAlpha: smoothstep band on |value|."""
    a = jnp.abs(value)
    t = jnp.clip((a - 0.01) / (0.15 - 0.01), 0.0, 1.0)
    s = t * t * (3.0 - 2.0 * t)
    return jnp.where(a < 0.01, 0.0, s)


def _shift(img, dy, dx):
    """Clamped-edge neighbour tap (the reference samples with CLAMP)."""
    h, w = img.shape
    ys = jnp.clip(jnp.arange(h) + dy, 0, h - 1)
    xs = jnp.clip(jnp.arange(w) + dx, 0, w - 1)
    return img[ys][:, xs]


def heightmap_to_normals(
    heightmap,
    normals_are_signed: bool = False,
    normal_elevation_clamping: bool = False,
):
    """ProcessHeightmap.fx HeightmapToNormals (+ calculateNormal,
    ProcessHeightmap.fxh:30-88): central differences of the heightmap with
    elevation clamping and the synthesized-alpha mask -> (H, W, 4)."""
    center = heightmap
    a = _shift(heightmap, 0, -1)
    b = _shift(heightmap, 0, 1)
    c = _shift(heightmap, -1, 0)
    d = _shift(heightmap, 1, 0)

    alpha = jnp.maximum(
        _synthesize_alpha(center),
        jnp.maximum(
            jnp.maximum(_synthesize_alpha(a), _synthesize_alpha(b)),
            jnp.maximum(_synthesize_alpha(c), _synthesize_alpha(d)),
        ),
    )
    if normal_elevation_clamping:
        a = jnp.minimum(a, center)
        b = jnp.minimum(b, center)
        c = jnp.minimum(c, center)
        d = jnp.minimum(d, center)

    eps = 0.001
    all_flat = (
        (jnp.abs(center) < eps) & (jnp.abs(a) < eps) & (jnp.abs(b) < eps)
        & (jnp.abs(c) < eps) & (jnp.abs(d) < eps)
    )
    alpha = jnp.where(all_flat, 0.0, alpha)

    n = jnp.stack([a - b, c - d, jnp.full_like(center, 0.5)], axis=-1)
    n = n / jnp.sqrt(jnp.maximum(jnp.sum(n * n, axis=-1, keepdims=True),
                                 1e-12))
    encoded = n if normals_are_signed else n * 0.5 + 0.5
    return jnp.concatenate([encoded, alpha[..., None]], axis=-1)


def heightmap_to_displacement(heightmap, displacement_scale=(1.0, 1.0),
                              normal_elevation_clamping: bool = False):
    """ProcessHeightmap.fx HeightmapToDisplacement: normal.xy scaled into
    a 0.5-biased displacement map (H, W, 4)."""
    n = heightmap_to_normals(heightmap, normals_are_signed=True,
                             normal_elevation_clamping=
                             normal_elevation_clamping)
    dx = n[..., 0] * displacement_scale[0] + 0.5
    dy = n[..., 1] * displacement_scale[1] + 0.5
    half = jnp.full_like(dx, 0.5)
    one = jnp.ones_like(dx)
    return jnp.stack([dx, dy, half, one], axis=-1)


def height_from_distance(
    distance,
    min_distance: float = 0.0,
    max_distance: float = 32.0,
    min_height: float = 0.0,
    max_height: float = 1.0,
    distance_power_1: float = 1.0,
    distance_power_2: float = 1.0,
):
    """ProcessHeightmap.fx HeightFromDistance: a (JumpFlood-style) distance
    image -> heightmap. Pixels beyond max_distance write 0 (the discard);
    negative distance (interior) is higher, so height runs max -> min as
    distance increases (:20-43)."""
    d = jnp.maximum(min_distance, distance)
    outside = d > max_distance
    t = (d - min_distance) / jnp.maximum(max_distance - min_distance, 1e-6)
    t = 1.0 - jnp.power(
        1.0 - jnp.clip(jnp.power(jnp.clip(t, 0.0, 1.0), distance_power_1),
                       0.0, 1.0),
        distance_power_2,
    )
    h = max_height + (min_height - max_height) * t
    h = jnp.where(outside, 0.0, h)
    one = jnp.where(outside, 0.0, 1.0)
    return jnp.stack([h, h, h, one], axis=-1)
