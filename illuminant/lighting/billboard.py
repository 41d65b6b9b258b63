"""G-buffer billboards: sprites that stand up in the 2.5D scene.

Port of /root/reference/Illuminant/Billboard.cs +
LightingRenderer.GBuffer.cs RenderGBufferBillboards (:331-506) +
GBufferBitmap.fx: a screen rectangle whose covered pixels write normal/z
into the G-buffer so sprites receive 2.5D lighting and cast correct
relative-Y positions. Mask mode uses the texture alpha (or the full rect)
as a silhouette whose world z rises from the bottom edge (characters
standing on the ground); cylinder factor bends horizontal normals.
GBufferData mode writes the texture's own encoded channels.

Array form: billboards are few; each rasterizes analytically over the pixel
grid (texture alpha lookups are structured gathers over small sprites).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import jax.numpy as jnp

from ..core.pytree import pytree_dataclass
from ..ops.coords import decode_normal_spherical
from .environment import EnvironmentUniforms
from .gbuffer import GBuffer

TYPE_MASK = 0
TYPE_GBUFFER_DATA = 1
# AutoGBufferBitmap.fx variants: infer g-data from an ordinary sprite.
TYPE_AUTO = 2          # AutoGBufferBitmapPixelShader (:12-57)
TYPE_NORMAL_BILLBOARD = 3  # NormalBillboardPixelShader (:59-101)


@dataclasses.dataclass
class Billboard:
    """Host billboard (Billboard.cs:9-87)."""

    screen_bounds: Tuple[float, float, float, float] = (0, 0, 32, 32)
    texture: Optional[np.ndarray] = None  # (TH, TW, 4); None -> full rect
    type: int = TYPE_MASK
    normal: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    world_elevation: float = 0.0  # z of the billboard's bottom edge
    cylinder_factor: float = 0.0
    data_scale: float = 1.0
    static_lighting_only: bool = False
    enable_shadows: bool = True
    sort_key: float = 0.0
    # AutoGBufferBitmap parameters (AutoGBufferBitmap.fx userData /
    # ZFromDistance): normal_z < -900 disables directional occlusion.
    normal_z: float = 0.0
    z_to_y_ratio: float = 0.0
    base_z: float = 0.0
    fullbright: bool = False
    normals_are_signed: bool = False
    distance_texture: Optional[np.ndarray] = None  # (TH, TW) f32
    # (min z offset, max z offset, distance scale)
    z_from_distance: Tuple[float, float, float] = (0.0, 0.0, 0.0)


def rasterize_billboards(gbuffer: GBuffer, billboards: List[Billboard],
                         env: EnvironmentUniforms) -> GBuffer:
    """Write billboards into the G-buffer in sort order (the reference
    sorts by SortKey/type/texture, GBuffer.cs:353-367)."""
    h, w = gbuffer.shape
    scale = gbuffer.render_scale
    ys = (jnp.arange(h, dtype=jnp.float32) + 0.5) / scale
    xs = (jnp.arange(w, dtype=jnp.float32) + 0.5) / scale
    gy, gx = jnp.meshgrid(ys, xs, indexing="ij")

    normal = gbuffer.normal
    rel_y = gbuffer.relative_y
    z = gbuffer.z
    shadows = gbuffer.enable_shadows
    fullbright = gbuffer.fullbright

    for b in sorted(billboards, key=lambda b: b.sort_key):
        x0, y0, x1, y1 = b.screen_bounds
        inside = (gx >= x0) & (gx < x1) & (gy >= y0) & (gy < y1)
        u = jnp.clip((gx - x0) / max(x1 - x0, 1e-6), 0.0, 1.0)
        v = jnp.clip((gy - y0) / max(y1 - y0, 1e-6), 0.0, 1.0)

        if b.texture is not None:
            tex = jnp.asarray(b.texture, jnp.float32)
            th, tw = tex.shape[0], tex.shape[1]
            ti = jnp.clip((v * th).astype(jnp.int32), 0, th - 1)
            tj = jnp.clip((u * tw).astype(jnp.int32), 0, tw - 1)
            texel = tex[ti, tj]
            alpha_ok = texel[..., 3] > 0.5
        else:
            texel = None
            alpha_ok = jnp.ones_like(inside)
        hit = inside & alpha_ok

        if b.type == TYPE_MASK:
            # Mask: silhouette stands up — world z rises from the bottom
            # edge by screen height * DataScale (Billboard.cs:49-52),
            # screen y folds into relativeY so the lit world-y is the
            # billboard's ground line.
            height_px = (y1 - y0)
            bz = (
                b.world_elevation
                + (1.0 - v) * height_px * b.data_scale
                * jnp.maximum(env.z_to_y_multiplier, 0.0)
            )
            b_rel = (y1 - gy) * b.data_scale  # anchor at the bottom edge
            # Cylinder normal bend (Billboard.cs:44-47).
            n0 = jnp.asarray(b.normal, jnp.float32)
            n0 = n0 / jnp.sqrt(jnp.maximum(jnp.sum(n0 * n0), 1e-12))
            side = (u * 2.0 - 1.0) * b.cylinder_factor
            bend = jnp.sqrt(jnp.maximum(1.0 - side * side, 0.0))
            n = jnp.stack(
                [
                    n0[0] * bend + side,
                    jnp.broadcast_to(n0[1] * bend, side.shape),
                    jnp.broadcast_to(n0[2], side.shape),
                ],
                axis=-1,
            )
            nl = jnp.sqrt(jnp.maximum(jnp.sum(n * n, axis=-1,
                                              keepdims=True), 1e-12))
            n = n / nl
        elif b.type == TYPE_GBUFFER_DATA:
            # GBufferData: texture channels carry (encoded normal.xy,
            # relativeY, z) scaled by DataScale (Billboard.cs:88-117).
            enc = texel[..., :2]
            n = decode_normal_spherical(enc)
            b_rel = texel[..., 2] * b.data_scale
            bz = texel[..., 3] * b.data_scale
        elif b.type == TYPE_AUTO:
            # AutoGBufferBitmap (:32-56): normal from the scalar normal_z,
            # relativeY measured up from the sprite's bottom edge (the
            # origin line), z = base + zToYRatio * relativeY (+ optional
            # distance-texture offset).
            nz = b.normal_z
            if nz < -900.0:
                n = jnp.zeros(gy.shape + (3,), jnp.float32)
            else:
                n0 = np.asarray(
                    [0.0, 1.0 - abs(nz), nz], np.float32)
                n0 = n0 / max(np.linalg.norm(n0), 1e-9)
                n = jnp.broadcast_to(jnp.asarray(n0), gy.shape + (3,))
            b_rel = (y1 - gy) * b.data_scale
            bz = b.base_z + b.z_to_y_ratio * b_rel
            if b.distance_texture is not None and                     abs(b.z_from_distance[2]) > 0.001:
                dt = jnp.asarray(b.distance_texture, jnp.float32)
                dh, dw = dt.shape[0], dt.shape[1]
                di = jnp.clip((v * dh).astype(jnp.int32), 0, dh - 1)
                dj = jnp.clip((u * dw).astype(jnp.int32), 0, dw - 1)
                dist = dt[di, dj]
                bz = bz + jnp.clip(
                    b.z_from_distance[2] * dist,
                    b.z_from_distance[0], b.z_from_distance[1],
                )
        else:
            # NormalBillboard (:59-101): normal straight from the sprite
            # rgb (signed or 0.5-biased); dead where alpha low or the
            # normal vector ~zero.
            rgb = texel[..., :3]
            n = rgb if b.normals_are_signed else (rgb - 0.5) * 2.0
            nl2 = jnp.sqrt(jnp.maximum(jnp.sum(n * n, axis=-1,
                                               keepdims=True), 1e-12))
            hit = hit & (nl2[..., 0] > 0.01)
            n = n / nl2
            b_rel = (y1 - gy) * b.data_scale
            bz = b.base_z + b.z_to_y_ratio * b_rel

        hit3 = hit[..., None]
        normal = jnp.where(hit3, n, normal)
        rel_y = jnp.where(hit, b_rel, rel_y)
        z = jnp.where(hit, bz, z)
        shadows = jnp.where(
            hit, 1.0 if b.enable_shadows else 0.0, shadows
        )
        fullbright = jnp.where(
            hit, 1.0 if getattr(b, "fullbright", False) else 0.0,
            fullbright,
        )

    return gbuffer.replace(
        normal=normal, relative_y=rel_y, z=z, enable_shadows=shadows,
        fullbright=fullbright,
    )
