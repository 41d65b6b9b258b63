"""3D color LUT grading: dark/bright LUT blend by scene brightness.

Port of /root/reference/Illuminant/Shaders/LUTResolve.fx
(LUTBlendedResolveWithAlbedoCommon :60-115) and LUTBlendingConfiguration
(LightingRenderer.HDR.cs:260-273): albedo is graded through two 3D LUTs
(a dark and a bright look) blended by the local light level, optionally
with a neutral band where the raw albedo passes through, and optionally
per-channel.

LUTs here are (N, N, N, 3) arrays indexed [b][g][r] (the reference packs
them as 2D texture strips — ColorLUT in Squared.Render; the array form is
the natural array layout). Trilinear LUT fetches are gathers, acceptable
for a grading pass.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import jax.numpy as jnp

from ..ops.tonemap import RGB_TO_LUMINANCE


def identity_lut(size: int = 16) -> np.ndarray:
    r = np.linspace(0.0, 1.0, size, dtype=np.float32)
    b, g, rr = np.meshgrid(r, r, r, indexing="ij")
    return np.stack([rr, g, b], axis=-1)


def sample_lut(lut, rgb):
    """Trilinear (..., 3) lookup in an (N, N, N, 3) LUT."""
    n = lut.shape[0]
    c = jnp.clip(rgb, 0.0, 1.0) * (n - 1)
    c0 = jnp.floor(c)
    f = c - c0
    c0 = c0.astype(jnp.int32)
    c1 = jnp.clip(c0 + 1, 0, n - 1)

    def fetch(ri, gi, bi):
        return lut[bi, gi, ri]

    r0, g0, b0 = c0[..., 0], c0[..., 1], c0[..., 2]
    r1, g1, b1 = c1[..., 0], c1[..., 1], c1[..., 2]
    fr, fg, fb = f[..., 0:1], f[..., 1:2], f[..., 2:3]

    v000 = fetch(r0, g0, b0)
    v100 = fetch(r1, g0, b0)
    v010 = fetch(r0, g1, b0)
    v110 = fetch(r1, g1, b0)
    v001 = fetch(r0, g0, b1)
    v101 = fetch(r1, g0, b1)
    v011 = fetch(r0, g1, b1)
    v111 = fetch(r1, g1, b1)
    v00 = v000 + (v100 - v000) * fr
    v10 = v010 + (v110 - v010) * fr
    v01 = v001 + (v101 - v001) * fr
    v11 = v011 + (v111 - v011) * fr
    v0 = v00 + (v10 - v00) * fg
    v1 = v01 + (v11 - v01) * fg
    return v0 + (v1 - v0) * fb


@dataclasses.dataclass
class LUTBlendingConfiguration:
    dark_lut: np.ndarray = None
    bright_lut: Optional[np.ndarray] = None
    per_channel: bool = False
    lut_only: bool = False
    dark_level: float = 0.0
    bright_level: float = 1.0
    neutral_band_size: float = 0.0


def lut_blended_resolve(albedo, lightmap, config: LUTBlendingConfiguration,
                        inverse_scale: float = 1.0):
    """(H, W, 4) albedo x lightmap -> graded (H, W, 4)
    (LUTResolve.fx:60-115)."""
    dark = jnp.asarray(
        config.dark_lut if config.dark_lut is not None else identity_lut()
    )
    bright = jnp.asarray(
        config.bright_lut if config.bright_lut is not None else dark
    )
    light = lightmap * inverse_scale

    weight = light[..., :3]
    band_width = jnp.clip(config.bright_level - config.dark_level, 0.0, 1.0)
    neutral = min(config.neutral_band_size, float(band_width) - 0.01)
    has_neutral = neutral > 0.0
    if (not config.per_channel) or has_neutral:
        weight = jnp.sum(
            weight * RGB_TO_LUMINANCE, axis=-1, keepdims=True
        )

    base = jnp.clip(albedo[..., :3], 0.0, 1.0)
    v1 = sample_lut(dark, base)
    v2 = sample_lut(bright, base)

    if has_neutral:
        transition = (float(band_width) - neutral) * 0.5
        v = weight[..., :1] - config.dark_level
        v3 = v - transition - neutral
        t1 = jnp.clip(v / max(transition, 1e-6), 0.0, 1.0)
        t2 = jnp.clip(v3 / max(transition, 1e-6), 0.0, 1.0)
        val1 = v1 + (base - v1) * t1
        blended = val1 + (v2 - val1) * t2
    else:
        w = weight - config.dark_level
        if config.bright_level > config.dark_level:
            w = jnp.clip(
                w / (config.bright_level - config.dark_level), 0.0, 1.0
            )
        else:
            w = jnp.clip(w, 0.0, 1.0)
        blended = v1 + (v2 - v1) * w

    out_rgb = blended if config.lut_only else blended * light[..., :3]
    return jnp.concatenate([out_rgb, albedo[..., 3:4]], axis=-1)
