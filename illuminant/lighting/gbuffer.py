"""The 2.5D G-buffer.

Reference: /root/reference/Illuminant/GBuffer.cs and
Lighting/LightingRenderer.GBuffer.cs — a Vector4 target encoding
(spherical normal.xy, relativeY, biased Z) per pixel, rasterized from the
ground plane, height-volume faces, and billboards
(GBufferShaderCommon.fxh:10-35, LightCommon.fxh:58-144).

Array design: planar struct-of-arrays instead of a packed RGBA encoding —
`normal` (H, W, 3) raw, `relative_y`/`z` (H, W) f32, and boolean flags
instead of the Z-negation/+99999 tricks (those existed to smuggle flags
through a texture). `world_position()` reconstructs shading positions the
same way sampleGBuffer does: world.xy = pixel.xy / render_scale +
(0, relativeY), world.z from the buffer.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core.pytree import pytree_dataclass, static_field
from .environment import EnvironmentUniforms


@pytree_dataclass
class GBuffer:
    """normal: (H, W, 3); an all-zero normal disables directional occlusion
    (LightCommon.fxh:129-131). relative_y/z: (H, W). enable_shadows /
    fullbright: (H, W) f32 0/1 flags (LightCommon.fxh:83-94).

    `pixel_origin` ((2,) [ox, oy], possibly traced): the pixel coordinate
    of this buffer's top-left corner in the FULL frame — nonzero for the
    windowed views `window()` cuts for bounded lights (the array analog of
    the reference's per-light instanced quads, LightingRenderer.cs:
    1149-1166, which never shade pixels outside a light's bounds)."""

    normal: jnp.ndarray
    relative_y: jnp.ndarray
    z: jnp.ndarray
    enable_shadows: jnp.ndarray
    fullbright: jnp.ndarray
    render_scale: float = static_field(default=1.0)
    pixel_origin: jnp.ndarray = None

    def _origin(self):
        if self.pixel_origin is None:
            return jnp.zeros((2,), jnp.float32)
        return self.pixel_origin.astype(jnp.float32)

    @property
    def shape(self):
        return self.z.shape

    def _pixel_grid(self):
        h, w = self.z.shape
        o = self._origin()
        ys = (jnp.arange(h, dtype=jnp.float32) + 0.5 + o[1]) \
            / self.render_scale
        xs = (jnp.arange(w, dtype=jnp.float32) + 0.5 + o[0]) \
            / self.render_scale
        return jnp.meshgrid(ys, xs, indexing="ij")

    def world_position(self):
        """Reconstruct shaded world positions (H, W, 3)
        (LightCommon.fxh:118-122 with viewport scale 1, position 0)."""
        gy, gx = self._pixel_grid()
        return jnp.stack([gx, gy + self.relative_y, self.z], axis=-1)

    def camera_position(self, env: EnvironmentUniforms):
        """Approximate per-pixel camera position (LightCommon.fxh:98-99):
        straight above each pixel at maximum_z + 0.01."""
        gy, gx = self._pixel_grid()
        cz = jnp.broadcast_to(env.maximum_z + 0.01, gx.shape)
        return jnp.stack([gx, gy, cz], axis=-1)

    def window(self, oy, ox, win_h: int, win_w: int) -> "GBuffer":
        """Cut a (win_h, win_w) view at pixel origin (oy, ox) — the
        caller clamps the origin into bounds (window_origin). Python-int
        origins cut STATIC slices (shard-safe on a row-sharded buffer —
        see lighting/windowed.py module note); traced origins fall back
        to dynamic slices."""
        import jax.lax as lax

        if isinstance(oy, int) and isinstance(ox, int):
            def cut(a):
                return a[oy:oy + win_h, ox:ox + win_w]
        else:
            def cut(a):
                out = lax.dynamic_slice_in_dim(a, oy, win_h, 0)
                return lax.dynamic_slice_in_dim(out, ox, win_w, 1)

        return GBuffer(
            normal=cut(self.normal),
            relative_y=cut(self.relative_y),
            z=cut(self.z),
            enable_shadows=cut(self.enable_shadows),
            fullbright=cut(self.fullbright),
            render_scale=self.render_scale,
            pixel_origin=self._origin()
            + jnp.stack([ox, oy]).astype(jnp.float32),
        )


def flat_ground(height: int, width: int, env: EnvironmentUniforms,
                render_scale: float = 1.0,
                enable_shadows: bool = True) -> GBuffer:
    """Ground-plane-only G-buffer (RenderGroundPlane,
    LightingRenderer.GBuffer.cs:271-329): normal +z, z = ground_z."""
    h, w = height, width
    normal = jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, 1.0], jnp.float32), (h, w, 3)
    )
    return GBuffer(
        normal=normal,
        relative_y=jnp.zeros((h, w), jnp.float32),
        z=jnp.broadcast_to(env.ground_z, (h, w)).astype(jnp.float32),
        enable_shadows=jnp.full((h, w), 1.0 if enable_shadows else 0.0,
                                jnp.float32),
        fullbright=jnp.zeros((h, w), jnp.float32),
        render_scale=render_scale,
    )


def no_gbuffer(height: int, width: int, env: EnvironmentUniforms,
               render_scale: float = 1.0) -> GBuffer:
    """EnableGBuffer=false path (LightCommon.fxh:132-141): every pixel is
    the ground plane with a +z normal and shadows enabled."""
    return flat_ground(height, width, env, render_scale, enable_shadows=True)
