"""Projector lights: project a texture onto the scene.

Port of /root/reference/Illuminant/Shaders/ProjectorLightCore.fxh and
ProjectorLightSource (Lighting/LightSource.cs:507-600): the shaded world
position maps through the projector's INVERSE transform into texture space
(fxh:43-52), samples the projection texture within a region with optional
wrap/clamp falloff (fxh:55-67, 290-301), and an optional origin point adds
a normal factor plus cone-traced shadows (fxh:76-77, 134-137).

The per-pixel texture fetch is a genuine gather; projector lights are an editor/authoring feature used in
ones, so correctness wins over a bespoke kernel here.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core.config import QualitySettings
from ..core.pytree import pytree_dataclass
from .cone_trace import cone_trace
from .environment import EnvironmentUniforms
from .gbuffer import GBuffer
from .sphere import compute_ao, compute_normal_factor


@pytree_dataclass
class ProjectorLights:
    inverse_matrix: jnp.ndarray  # (L, 4, 4) world -> projector space
    texture: jnp.ndarray  # (L, TH, TW, 4) projection textures (uniform size)
    # radius, ramp_length, ramp_mode, cast_shadows.
    properties: jnp.ndarray  # (L, 4)
    # ao_radius, opacity, wrap(0)/clamp-falloff(1), ao_opacity.
    more: jnp.ndarray  # (L, 4)
    texture_region: jnp.ndarray  # (L, 4) x1 y1 x2 y2 in uv space
    origin: jnp.ndarray  # (L, 4) xyz + has_origin
    color: jnp.ndarray  # (L, 4) modulation color
    active: jnp.ndarray  # (L,)
    mip_bias: jnp.ndarray  # (L,)
    # Mip pyramid of `texture` (level 0 excluded), tuple of
    # (L, TH/2^k, TW/2^k, 4) — static length.
    mips: tuple = ()
    # Per-light (actual / padded) texture extent fractions (h, w):
    # mixed-size textures pad to the max dims; uv rescales by this so
    # each light's image spans its full projection.
    tex_size: jnp.ndarray = None  # (L, 2)

    @property
    def capacity(self):
        return self.inverse_matrix.shape[0]


@dataclasses.dataclass
class ProjectorLightSource:
    """Host (LightSource.cs:507-600). `transform` maps projector/texture
    space ([0,1]^2 at z=0) into the world; the inverse is taken at pack."""

    texture: np.ndarray = None  # (TH, TW, 4) float
    transform: np.ndarray = None  # (4, 4) row-vector world transform
    position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    scale: Tuple[float, float] = (128.0, 128.0)
    opacity: float = 1.0
    wrap: bool = False
    origin: Optional[Tuple[float, float, float]] = None
    cast_shadows: bool = False
    radius: float = 4.0
    ramp_length: float = 128.0
    # tex2Dbias LOD offset (LightSource.cs projector MipBias): biases the
    # derivative-computed mip level of the projected texture.
    mip_bias: float = 0.0
    color: tuple = (1.0, 1.0, 1.0, 1.0)
    ambient_occlusion_radius: float = 0.0
    ambient_occlusion_opacity: float = 1.0
    texture_region: Tuple[float, float, float, float] = (0.0, 0.0, 1.0, 1.0)
    # LightSource.BlendMode (LightSource.cs:65); the ProjectorLight demo
    # flips a darkness projector to "subtractive" (ProjectorLight.cs:321).
    blend_mode: str = "additive"

    def world_matrix(self) -> np.ndarray:
        if self.transform is not None:
            return np.asarray(self.transform, np.float32)
        m = np.eye(4, dtype=np.float32)
        m[0, 0] = self.scale[0]
        m[1, 1] = self.scale[1]
        m[3, :3] = self.position
        return m


def pack_projector_lights(lights: List[ProjectorLightSource]
                          ) -> ProjectorLights:
    n = max(len(lights), 1)
    th = max((l.texture.shape[0] for l in lights if l.texture is not None),
             default=1)
    tw = max((l.texture.shape[1] for l in lights if l.texture is not None),
             default=1)
    inv = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    tex = np.zeros((n, th, tw, 4), np.float32)
    props = np.zeros((n, 4), np.float32)
    more = np.zeros((n, 4), np.float32)
    region = np.tile(np.asarray([0, 0, 1, 1], np.float32), (n, 1))
    origin = np.zeros((n, 4), np.float32)
    color = np.zeros((n, 4), np.float32)
    active = np.zeros((n,), np.float32)
    tex_size = np.ones((n, 2), np.float32)
    for i, l in enumerate(lights):
        try:
            inv[i] = np.linalg.inv(l.world_matrix())
        except np.linalg.LinAlgError:
            # Degenerate transform (zero scale): degrade to an inactive
            # light like the reference's inf-determinant garbage render,
            # instead of aborting the whole pack.
            continue
        if l.texture is not None:
            t = np.asarray(l.texture, np.float32)
            tex[i, : t.shape[0], : t.shape[1]] = t
            # Actual-vs-padded extent: mixed-size textures pad to the
            # max dims, and sampling rescales uv by this fraction so
            # each light's image spans its full projection (not a
            # corner of the padded atlas).
            tex_size[i] = [t.shape[0] / th, t.shape[1] / tw]
        else:
            tex_size[i] = [1.0, 1.0]
        props[i] = [l.radius, l.ramp_length, 0.0,
                    1.0 if l.cast_shadows else 0.0]
        more[i] = [l.ambient_occlusion_radius, l.opacity,
                   0.0 if l.wrap else 1.0, l.ambient_occlusion_opacity]
        region[i] = l.texture_region
        if l.origin is not None:
            origin[i] = [*l.origin, 1.0]
        color[i] = l.color
        active[i] = 1.0
    # Mip pyramid (2x2 box) for tex2Dbias emulation.
    mips = []
    level = tex
    while min(level.shape[1], level.shape[2]) >= 2:
        # PAD odd dimensions (edge-replicate) before the 2x2 pool —
        # cropping shifted mip content relative to uv space,
        # compounding per level on non-power-of-two textures.
        if level.shape[1] % 2:
            level = np.concatenate([level, level[:, -1:]], axis=1)
        if level.shape[2] % 2:
            level = np.concatenate([level, level[:, :, -1:]], axis=2)
        level = 0.25 * (
            level[:, 0::2, 0::2] + level[:, 1::2, 0::2]
            + level[:, 0::2, 1::2] + level[:, 1::2, 1::2]
        )
        mips.append(jnp.asarray(level))
        if len(mips) >= 5:
            break
    return ProjectorLights(
        inverse_matrix=jnp.asarray(inv),
        texture=jnp.asarray(tex),
        properties=jnp.asarray(props),
        more=jnp.asarray(more),
        texture_region=jnp.asarray(region),
        origin=jnp.asarray(origin),
        color=jnp.asarray(color),
        active=jnp.asarray(active),
        mip_bias=jnp.asarray(
            ([getattr(l, "mip_bias", 0.0) for l in lights]
             + [0.0] * n)[:n], jnp.float32),
        mips=tuple(mips),
        tex_size=jnp.asarray(tex_size),
    )


def support_radius_px(lights: List[ProjectorLightSource],
                      render_scale: float = 1.0):
    """Conservative per-light support radius in pixels around each
    projected quad's center (position + scale/2): the half-diagonal of
    the scaled quad plus the ramp/falloff reach. Used to size/validate
    the bounded evaluation window (the reference sizes each projector's
    quad from its transform instead, LightingRenderer.cs:1193-1446)."""
    import math as _math

    out = []
    for l in lights:
        half_diag = 0.5 * _math.hypot(l.scale[0], l.scale[1])
        out.append((half_diag + max(getattr(l, "ramp_length", 0.0), 0.0))
                   * render_scale)
    return np.asarray(out, np.float32)


def _transform_point(p, m):
    """Row-vector homogeneous transform with perspective divide
    (fxh:43-44). Explicit mul/adds (bf16 matmul hazard)."""
    out = (
        p[..., 0:1] * m[..., 0, :]
        + p[..., 1:2] * m[..., 1, :]
        + p[..., 2:3] * m[..., 2, :]
        + m[..., 3, :]
    )
    w = jnp.where(jnp.abs(out[..., 3:4]) > 1e-9, out[..., 3:4], 1.0)
    return out / w


def _sample_texture_bilinear(tex, u, v, wrap):
    """tex (TH, TW, 4); u/v in [0, 1]. Gather-based (see module note)."""
    th, tw = tex.shape[0], tex.shape[1]
    x = u * tw - 0.5
    y = v * th - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]

    def idx(a, n):
        ai = a.astype(jnp.int32)
        return jnp.where(wrap > 0.5, jnp.mod(ai, n), jnp.clip(ai, 0, n - 1))

    x0i = idx(x0, tw)
    x1i = idx(x0 + 1, tw)
    y0i = idx(y0, th)
    y1i = idx(y0 + 1, th)
    v00 = tex[y0i, x0i]
    v01 = tex[y0i, x1i]
    v10 = tex[y1i, x0i]
    v11 = tex[y1i, x1i]
    top = v00 + (v01 - v00) * fx
    bot = v10 + (v11 - v10) * fx
    return top + (bot - top) * fy


def _sample_texture_mipped(lights, i, uv, wrap):
    """tex2Dbias emulation (ProjectorLightCore mip bias): per-pixel LOD
    from the projected-uv screen derivative (finite difference along the
    pixel grid) + the light's MipBias, trilinear across a precomputed
    2x2-box pyramid. Falls back to plain bilinear when no pyramid exists
    or the uv field has no screen extent (probes)."""
    base = lights.texture[i]
    u = uv[..., 0]
    v = uv[..., 1]
    if lights.tex_size is not None:
        # Content-uv -> padded-atlas uv: wrap tiles over the ACTUAL
        # texture extent, then both axes rescale by actual/padded so a
        # smaller texture in a mixed-size pack spans its full
        # projection instead of a corner of the padded atlas.
        frac_h = lights.tex_size[i, 0]
        frac_w = lights.tex_size[i, 1]
        u = jnp.where(wrap > 0.5, jnp.mod(u, 1.0), u) * frac_w
        v = jnp.where(wrap > 0.5, jnp.mod(v, 1.0), v) * frac_h
        wrap = 0.0  # already wrapped in content space
    if not lights.mips or u.ndim < 2 or u.shape[-1] < 2:
        return _sample_texture_bilinear(base, u, v, wrap)
    th, tw = base.shape[0], base.shape[1]

    def _ediff(a, axis):
        # Forward difference with the EDGE repeating its neighbor's
        # value — a wrapped roll differenced the last row/column
        # against the first, forcing max-blur LOD on a 1-px border at
        # every window boundary.
        d = jnp.roll(a, -1, axis=axis) - a
        last = jax.lax.slice_in_dim(d, a.shape[axis] - 2,
                                    a.shape[axis] - 1, axis=axis)
        head = jax.lax.slice_in_dim(d, 0, a.shape[axis] - 1, axis=axis)
        return jnp.concatenate([head, last], axis=axis)

    dudx = _ediff(u, u.ndim - 1) * tw
    dvdx = _ediff(v, v.ndim - 1) * th
    dudy = _ediff(u, u.ndim - 2) * tw
    dvdy = _ediff(v, v.ndim - 2) * th
    foot = jnp.sqrt(jnp.maximum(
        jnp.maximum(dudx * dudx + dvdx * dvdx,
                    dudy * dudy + dvdy * dvdy), 1e-12))
    n_levels = len(lights.mips)
    lod = jnp.clip(
        0.5 * jnp.log2(jnp.maximum(foot * foot, 1e-12))
        + lights.mip_bias[i],
        0.0, float(n_levels),
    )
    out = _sample_texture_bilinear(base, u, v, wrap) * jnp.clip(
        1.0 - lod, 0.0, 1.0)[..., None]
    for lvl in range(n_levels):
        wgt = jnp.clip(1.0 - jnp.abs(lod - (lvl + 1)), 0.0, 1.0)
        out = out + _sample_texture_bilinear(
            lights.mips[lvl][i], u, v, wrap) * wgt[..., None]
    return out


def accumulate_projector_lights(
    volume,
    gbuffer: GBuffer,
    lights: ProjectorLights,
    env: EnvironmentUniforms,
    quality: QualitySettings,
):
    """All projector lights -> (H, W, 4) additive HDR contribution."""
    world_pos = gbuffer.world_position()
    normal = gbuffer.normal
    h, w = gbuffer.shape

    out = jnp.zeros((h, w, 4), jnp.float32)
    # Projector count is tiny; loop per light (each needs its own texture).
    for i in range(lights.capacity):
        psp = _transform_point(world_pos, lights.inverse_matrix[i])
        region = lights.texture_region[i]
        uv = psp[..., :2] + region[:2]

        clamped = jnp.clip(uv, region[:2], region[2:])
        clamp_mode = lights.more[i, 2]
        # Clamp-mode falloff includes the projector-space Z overshoot
        # like the reference's clamp3 (fxh:57-67): surfaces beyond the
        # unit z extent cull instead of being lit arbitrarily far away.
        zr = psp[..., 2]
        dz = zr - jnp.clip(zr, 0.0, 1.0)
        dist_out = jnp.sqrt(
            jnp.sum((clamped - uv) ** 2, axis=-1) + dz * dz
        )
        distance_opacity = jnp.where(
            clamp_mode > 0.5,
            jnp.maximum(1.0 - jnp.minimum(dist_out, 0.001) * 1000.0, 0.0),
            1.0,
        )
        uv_final = uv + (clamped - uv) * clamp_mode  # fxh:74

        origin = lights.origin[i]
        light_normal = world_pos - origin[:3]
        ln = light_normal / jnp.sqrt(
            jnp.maximum(jnp.sum(light_normal**2, axis=-1, keepdims=True),
                        1e-12)
        )
        nf = compute_normal_factor(ln, normal)
        normal_opacity = 1.0 + (nf - 1.0) * origin[3]

        constant_opacity = lights.more[i, 1]
        visible = (
            (distance_opacity > 0.0)
            & (world_pos[..., 0] > -9999.0)
            & (gbuffer.fullbright < 0.5)
        )

        ao_radius = lights.more[i, 0] * jnp.maximum(0.0, normal[..., 2])
        ao = compute_ao(volume, world_pos, normal, ao_radius,
                        lights.more[i, 3], visible)

        trace_enable = (
            visible
            & (lights.properties[i, 3] * gbuffer.enable_shadows > 0.0)
            & (origin[3] > 0.5)
            & (lights.active[i] > 0.0)
        )
        cone = cone_trace(
            volume, origin[:3], lights.properties[i, 0],
            lights.properties[i, 1], world_pos + 1.5 * normal,
            trace_enable, quality,
        )

        tex_color = _sample_texture_mipped(
            lights, i, uv_final, 1.0 - clamp_mode,
        )
        opacity = (
            distance_opacity * normal_opacity * constant_opacity * ao
            * cone
        )
        opacity = jnp.where(visible, opacity, 0.0) * lights.active[i]
        color = tex_color * lights.color[i]
        rgb = color[..., :3] * color[..., 3:4] * opacity[..., None]
        out = out + jnp.concatenate([rgb, opacity[..., None]], axis=-1)
    return out


# Convenience jitted alias (see scan_shadows.scan_visibility_jit): one
# whole-graph, persistent-cache-eligible compile for eager callers.
accumulate_projector_lights_jit = jax.jit(
    accumulate_projector_lights, static_argnames=("quality",))
