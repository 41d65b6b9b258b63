"""Randomness field: the array equivalent of the randomness textures.

The reference generates 807x653 Vector4 + Rgba64 randomness textures with
Xoshiro at startup (/root/reference/Illuminant/Particles/ParticleEngine.cs:
495-544) and samples them with wrap addressing — point sampling for
per-particle randomness (`random`, RandomCommon.fxh:27-34) and bilinear for
smooth spatial noise (`smoothRandom`, :36-43).

Here the field is a (H, W, 4) f32 array drawn once from a jax.random key
(behavioral, not bitwise, equivalence — SURVEY.md §7.1). Sampling uses the
same xy*rate + offset -> wrap convention so Noise/SpatialNoise transforms
produce the same *kind* of temporally-interpolated / spatially-smooth
fields.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.pytree import pytree_dataclass

# Reference texture dimensions (ParticleEngine.cs:497).
DEFAULT_WIDTH = 807
DEFAULT_HEIGHT = 653


@pytree_dataclass
class RandomField:
    data: jnp.ndarray  # (H, W, 4) f32 in [0, 1)

    @staticmethod
    def create(key, height: int = DEFAULT_HEIGHT,
               width: int = DEFAULT_WIDTH) -> "RandomField":
        return RandomField(
            data=jax.random.uniform(key, (height, width, 4), jnp.float32)
        )

    @property
    def shape(self):
        return self.data.shape[:2]


def point_sample(field: RandomField, xy, offset, rate=1.0):
    """randomCustom (RandomCommon.fxh:27-30): point sample with wrap.

    xy: (..., 2) sample coordinates; offset: (2,); rate: scalar or (2,).
    """
    h, w = field.shape
    coord = xy * rate + offset
    xi = jnp.mod(jnp.floor(coord[..., 0]).astype(jnp.int32), w)
    yi = jnp.mod(jnp.floor(coord[..., 1]).astype(jnp.int32), h)
    return field.data[yi, xi]


def bilinear_sample(field: RandomField, xy, offset, rate=1.0):
    """smoothRandomCustom (RandomCommon.fxh:36-39): bilinear with wrap."""
    h, w = field.shape
    coord = xy * rate + offset
    # GPU bilinear: texel centers at i + 0.5.
    tx = coord[..., 0] - 0.5
    ty = coord[..., 1] - 0.5
    x0 = jnp.floor(tx)
    y0 = jnp.floor(ty)
    wx = (tx - x0)[..., None]
    wy = (ty - y0)[..., None]
    x0i = jnp.mod(x0.astype(jnp.int32), w)
    x1i = jnp.mod(x0i + 1, w)
    y0i = jnp.mod(y0.astype(jnp.int32), h)
    y1i = jnp.mod(y0i + 1, h)
    v00 = field.data[y0i, x0i]
    v01 = field.data[y0i, x1i]
    v10 = field.data[y1i, x0i]
    v11 = field.data[y1i, x1i]
    top = v00 + (v01 - v00) * wx
    bot = v10 + (v11 - v10) * wx
    return top + (bot - top) * wy
