"""Volumetric lights (light shafts / glowing volumes).

Port of /root/reference/Illuminant/Shaders/VolumetricLightCore.fxh and
VolumetricLightSource (Lighting/LightSource.cs:372-466): an
ellipsoid/round-cone/box volume whose density a vertical per-pixel column
march accumulates (volumetricTrace :316-409 — each screen pixel integrates
the shape's interior ramp down its z column), plus a surface "diffuse" term
from the shape SDF at the shaded point (:462-505), blowout, and distance
attenuation. The shadowed variant occludes each column sample by marching
toward the ray origin (:358-392).

Packing (fxh:417-422): light_properties = (volumetricity, ramp_length,
ramp_mode, cast_shadows); even_more = (blowout, ramp_power,
distance_attenuation, shape).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core.config import QualitySettings
from ..core.pytree import pytree_dataclass
from ..sdf.analytic import scene_sample
from .environment import EnvironmentUniforms
from .gbuffer import GBuffer
from .sphere import (DOT_OFFSET, DOT_RAMP_RANGE, SELF_OCCLUSION_HACK,
                     compute_normal_factor)

SHAPE_ELLIPSOID = 0
SHAPE_CONE = 1
SHAPE_BOX = 2


def _saturate(x):
    return jnp.clip(x, 0.0, 1.0)


def _norm(v, eps=1e-12):
    return jnp.sqrt(jnp.maximum(jnp.sum(v * v, axis=-1), eps))


def sd_ellipsoid_simple(p, r):
    """fxh:25-29 (no near-field branch, unlike the obstruction version)."""
    k0 = _norm(p / r)
    k1 = _norm(p / (r * r))
    return k0 * (k0 - 1.0) / jnp.maximum(k1, 1e-9)


def sd_round_cone(p, a, b, r1, r2):
    """iq round cone between a (radius r1) and b (radius r2) (fxh:31-54)."""
    ba = b - a
    l2 = jnp.maximum(jnp.sum(ba * ba, axis=-1), 1e-9)
    rr = r1 - r2
    a2 = l2 - rr * rr
    il2 = 1.0 / l2

    pa = p - a
    y = jnp.sum(pa * ba, axis=-1)
    z = y - l2
    d = pa * l2[..., None] - ba * y[..., None]
    x2 = jnp.sum(d * d, axis=-1)
    y2 = y * y * l2
    z2 = z * z * l2

    k = jnp.sign(rr) * rr * rr * x2
    below = jnp.sign(z) * a2 * z2 > k
    above = jnp.sign(y) * a2 * y2 < k
    d_below = jnp.sqrt(jnp.maximum(x2 + z2, 0.0)) * il2 - r2
    d_above = jnp.sqrt(jnp.maximum(x2 + y2, 0.0)) * il2 - r1
    d_side = (jnp.sqrt(jnp.maximum(x2 * a2 * il2, 0.0)) + y * rr) * il2 - r1
    return jnp.where(below, d_below, jnp.where(above, d_above, d_side))


def sd_box_centered(p, half):
    d = jnp.abs(p) - half
    return jnp.minimum(jnp.max(d, axis=-1), 0.0) + _norm(
        jnp.maximum(d, 0.0)
    )


def shape_distance(position, start4, end4, shape):
    """eval (fxh:281-299): shape picked by id; start/end are (.., 4) with
    .w = radii (cone) / unused."""
    d_ell = sd_ellipsoid_simple(
        position - start4[..., :3], jnp.maximum(end4[..., :3], 1e-4)
    )
    d_cone = sd_round_cone(
        position, start4[..., :3], end4[..., :3], start4[..., 3],
        end4[..., 3],
    )
    d_box = sd_box_centered(position - start4[..., :3], end4[..., :3])
    return jnp.where(
        shape <= SHAPE_ELLIPSOID,
        d_ell,
        jnp.where(shape <= SHAPE_CONE, d_cone, d_box),
    )


@pytree_dataclass
class VolumetricLights:
    start: jnp.ndarray  # (L, 4) position + start radius
    end: jnp.ndarray  # (L, 4) position/size + end radius
    color: jnp.ndarray  # (L, 4)
    properties: jnp.ndarray  # (L, 4) volumetricity, ramp_len, mode, shadows
    more: jnp.ndarray  # (L, 4) ao_radius, falloff, y, ao_opacity
    even_more: jnp.ndarray  # (L, 4) blowout, ramp_power, dist_atten, shape
    active: jnp.ndarray  # (L,)

    @property
    def capacity(self):
        return self.start.shape[0]


@dataclasses.dataclass
class VolumetricLightSource:
    """Host (LightSource.cs:372-466)."""

    shape: int = SHAPE_CONE
    start_position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    end_position: Tuple[float, float, float] = (64.0, 0.0, 0.0)
    start_radius: float = 8.0
    end_radius: float = 0.0
    volumetricity: float = 1.0
    distance_attenuation: float = 1.0
    ramp_length: float = 1.0
    ramp_power: float = 1.0
    blowout_factor: float = 0.0
    ramp_mode: int = 0
    color: tuple = (1.0, 1.0, 1.0, 1.0)
    opacity: float = 1.0
    cast_shadows: bool = False
    # LightSource.BlendMode (LightSource.cs:65).
    blend_mode: str = "additive"


def pack_volumetric_lights(lights: List[VolumetricLightSource],
                           capacity: Optional[int] = None
                           ) -> VolumetricLights:
    n = len(lights)
    cap = capacity or max(n, 1)
    start = np.zeros((cap, 4), np.float32)
    end = np.ones((cap, 4), np.float32)
    color = np.zeros((cap, 4), np.float32)
    props = np.ones((cap, 4), np.float32)
    more = np.zeros((cap, 4), np.float32)
    more[:, 2] = 1.0
    more[:, 3] = 1.0
    even = np.zeros((cap, 4), np.float32)
    active = np.zeros((cap,), np.float32)
    for i, l in enumerate(lights):
        start[i] = [*l.start_position, l.start_radius]
        end[i] = [*l.end_position, l.end_radius]
        c = np.asarray(l.color, np.float32).copy()
        c[3] *= l.opacity
        color[i] = c
        props[i] = [
            max(l.volumetricity, 1e-3),
            max(l.ramp_length, 1e-3),
            float(l.ramp_mode),
            1.0 if l.cast_shadows else 0.0,
        ]
        even[i] = [
            l.blowout_factor,
            max(l.ramp_power, 1e-3),
            max(l.distance_attenuation, 1e-3),
            float(l.shape),
        ]
        active[i] = 1.0
    return VolumetricLights(
        start=jnp.asarray(start), end=jnp.asarray(end),
        color=jnp.asarray(color), properties=jnp.asarray(props),
        more=jnp.asarray(more), even_more=jnp.asarray(even),
        active=jnp.asarray(active),
    )


def support_radius_px(lights: VolumetricLights, render_scale: float = 1.0):
    """Conservative per-light xy support radius (pixels at render_scale)
    around start.xy — used to size/validate the bounded evaluation
    window (the reference sizes each light's instanced quad from its
    bounds instead, LightingRenderer.cs:1193-1446). Shape semantics
    (LightSource.cs:372-394): for cones start/end are endpoints with .w
    radii; for ellipsoids/boxes end.xyz IS the radius/half-size vector.
    The lit region extends ramp_length beyond the shape surface
    (ramp = saturate(-sd / rampLength))."""
    shape = lights.even_more[:, 3]
    cone_reach = (
        jnp.linalg.norm(lights.end[:, :2] - lights.start[:, :2], axis=-1)
        + jnp.maximum(lights.start[:, 3], lights.end[:, 3])
    )
    radial_reach = jnp.linalg.norm(lights.end[:, :2], axis=-1)
    reach = jnp.where(shape == SHAPE_CONE, cone_reach, radial_reach)
    ramp = lights.properties[:, 1]
    return (reach + ramp) * lights.active * render_scale


def volumetric_trace(volume, start4, end4, world_xy, world_z, env,
                     props, even_more, quality: QualitySettings,
                     shadowed: bool):
    """volumetricTrace (fxh:316-409): per-pixel vertical column integral.

    world_xy: (..., 2); returns (...,) opacity. Dithering of the column
    start is replaced by a half-step offset (the banding hack is only
    needed at 8-bit output).
    """
    shape = even_more[..., 3]
    steps = quality.max_step_count

    z2 = jnp.maximum(world_z, env.ground_z)
    z1 = jnp.maximum(env.maximum_z, z2)
    r = jnp.maximum(start4[..., 3], end4[..., 3])
    z_hi_cone = jnp.maximum(start4[..., 2], end4[..., 2]) + r
    z_lo_cone = jnp.minimum(start4[..., 2], end4[..., 2]) - r
    z_hi_other = start4[..., 2] + end4[..., 2]
    z_lo_other = start4[..., 2] - end4[..., 2]
    is_cone = shape == SHAPE_CONE
    z1 = jnp.minimum(z1, jnp.where(is_cone, z_hi_cone, z_hi_other))
    z2 = jnp.maximum(z2, jnp.where(is_cone, z_lo_cone, z_lo_other))

    step = jnp.maximum(jnp.abs(z2 - z1), 1.0) / steps
    ramp_length = props[..., 1]
    ramp_power = even_more[..., 1]

    # Broadcast shape of (lights x pixels): with L > 1 the per-light z
    # bounds are (L, 1, 1) while world_xy alone is (1, H, W, 2).
    out_shape = jnp.broadcast_shapes(
        world_xy.shape[:-1], start4.shape[:-1], props.shape[:-1]
    )

    def body(i, hits):
        z = z1 - (i + 0.5) * step
        pos = jnp.concatenate(
            [jnp.broadcast_to(world_xy, out_shape + world_xy.shape[-1:]),
             jnp.broadcast_to(z[..., None], out_shape + (1,))],
            axis=-1,
        )
        sd = shape_distance(pos, start4, end4, shape)
        ramp = _saturate(-sd / ramp_length) ** ramp_power
        if shadowed and volume is not None:
            # Inner occlusion march (fxh:358-392, projectFromOrigin):
            # sphere-step from the shape origin toward the column sample;
            # occlusion = saturate(lastSample * 0.5), zero on penetration
            # (sample <= -0.1), step = max(|sample| * 0.99, minStepSize).
            origin = start4[..., :3]
            toward = pos - origin
            md = _norm(toward)
            along = toward / md[..., None]
            # Full step budget like the reference's getStepLimit()
            # (fxh:362) — a quartered budget stalled mid-ray on long
            # shafts and darkened pixels the reference leaves lit.
            inner_steps = max(quality.max_step_count, 8)

            def march(_, carry):
                d, occ, done = carry
                sp = origin + along * d[..., None]
                s = scene_sample(volume, sp)
                occ_new = jnp.where(done, occ, _saturate(s * 0.5))
                blocked = (s <= -0.1) & ~done
                occ_new = jnp.where(blocked, 0.0, occ_new)
                d_new = d + jnp.maximum(
                    jnp.abs(s) * 0.99, quality.min_step_size
                )
                done_new = done | blocked | (d_new >= md)
                return (jnp.where(done, d, d_new), occ_new, done_new)

            init = (
                jnp.full(md.shape, 0.33, jnp.float32),  # dither*0.66 mean
                jnp.ones(md.shape, jnp.float32),
                jnp.zeros(md.shape, bool),
            )
            _, occ, _ = jax.lax.fori_loop(0, inner_steps, march, init)
        else:
            occ = 1.0
        valid = (z >= z2).astype(jnp.float32)
        return hits + ramp * occ * valid

    hits = jax.lax.fori_loop(
        0, steps, body, jnp.zeros(out_shape, jnp.float32)
    )
    return _saturate(hits / steps / props[..., 0])


def accumulate_volumetric_lights(
    volume,
    gbuffer: GBuffer,
    lights: VolumetricLights,
    env: EnvironmentUniforms,
    quality: QualitySettings,
    shadowed: bool = False,
    shadow_detail: str = "march",
):
    """All volumetric lights -> (H, W, 4) additive HDR contribution
    (VolumetricLightPixelCore, fxh:411-516).

    `shadow_detail` selects the shadowed path's occlusion source:
      * "march" — reference-exact per-(column-sample) inner sphere march
        (fxh:358-392 projectFromOrigin): max_step_count x inner_steps
        scene evals per pixel per light. The oracle; brutal at 1080p.
      * "scan" — ONE radial scan from each light's origin modulates the
        whole column integral by the pixel's 2D visibility. Deviation:
        occlusion is evaluated once per pixel (at the surface endpoint)
        instead of per column sample, so shadows inside the volume body
        lose their vertical gradient; shadow FOOTPRINTS on surfaces
        match. One scan instead of a march per column sample.
    """
    world_pos = gbuffer.world_position()
    normal = gbuffer.normal

    start4 = lights.start[:, None, None, :]
    end4 = lights.end[:, None, None, :]
    props = lights.properties[:, None, None, :]
    more = lights.more[:, None, None, :]
    even = lights.even_more[:, None, None, :]
    active = lights.active[:, None, None]
    shape = even[..., 3]

    visible = (world_pos[None, ..., 0] > -9999.0) & (
        gbuffer.fullbright[None] < 0.5
    )

    # AO is statically skipped: VolumetricLightSource exposes no AO
    # fields (pack leaves more[:, 0] at 0), so the per-call full-res
    # scene_sample was guaranteed dead work; re-enable by adding the
    # fields to the source + pack when the feature is needed.
    ao = 1.0

    if shadow_detail not in ("scan", "march"):
        raise ValueError(f"unknown shadow_detail {shadow_detail!r} "
                         "(expected 'scan' or 'march')")
    scan_occ = None
    if shadowed and shadow_detail == "scan":
        from .scan_shadows import scan_cone_visibility

        scan_occ = scan_cone_visibility(
            volume, gbuffer, lights.start[:, :3],
            jnp.maximum(lights.start[:, 3], 1.0),
            lights.properties[:, 1],
            quality, light_active=lights.active,
            self_occlusion_lift=SELF_OCCLUSION_HACK,
        ).astype(jnp.float32)

    vol_opacity = volumetric_trace(
        volume, start4, end4, world_pos[None, ..., :2],
        world_pos[None, ..., 2], env, props, even, quality,
        shadowed and shadow_detail == "march",
    )
    # Per-light CastsShadows gate (lightProperties.w, fxh:451): lights
    # with the flag off keep full visibility even in a shadowed pass —
    # mixed sets render in one call like the reference.
    occ_gate = props[..., 3] > 0.0
    if scan_occ is not None:
        vol_opacity = vol_opacity * jnp.where(occ_gate, scan_occ, 1.0)
    elif shadowed:
        # The march folded occlusion into vol_opacity; recover the
        # unshadowed trace for gated-off lights.
        vol_plain = volumetric_trace(
            volume, start4, end4, world_pos[None, ..., :2],
            world_pos[None, ..., 2], env, props, even, quality, False,
        )
        vol_opacity = jnp.where(occ_gate, vol_opacity, vol_plain)
    pre_trace = ao * vol_opacity

    # Diffuse surface term (fxh:462-494).
    cone_sharp = jnp.where(
        shape == SHAPE_CONE,
        jnp.maximum(start4[..., 3], end4[..., 3]) / 64.0,
        0.0,
    )
    dot_range = DOT_RAMP_RANGE + (0.33 - DOT_RAMP_RANGE) * cone_sharp
    dot_offset = DOT_OFFSET + (0.33 - DOT_OFFSET) * cone_sharp
    to_pixel = world_pos[None] - start4[..., :3]
    ln = to_pixel / _norm(to_pixel)[..., None]
    normal_opacity = compute_normal_factor(
        ln, normal[None], offset=dot_offset, range_=dot_range)
    # Blowout (fxh:485): lerp toward 2x-1 (can go negative).
    normal_opacity = normal_opacity + (
        (normal_opacity * 2.0 - 1.0) - normal_opacity
    ) * even[..., 0]

    contact = shape_distance(world_pos[None], start4, end4, shape)
    shape_opacity = jnp.where(
        contact < 0.0,
        _saturate(-contact / props[..., 1]) ** even[..., 1],
        0.0,
    )
    trajectory_len = jnp.where(
        shape == SHAPE_CONE,
        _norm(end4[..., :3] - start4[..., :3]),
        _norm(end4[..., :3]),
    )
    distance_opacity = 1.0 - _saturate(
        _norm(to_pixel) / jnp.maximum(trajectory_len * even[..., 2], 1e-6)
    )
    # NOTE: the reference's ramp-mode squaring (fxh:495-498) runs AFTER
    # diffuse is computed (fxh:492) and distanceOpacity is never read
    # again — dead code there, so no squaring here either (squaring
    # before diffuse halved the surface term for ramp_mode >= 1).
    diffuse = normal_opacity * shape_opacity * distance_opacity

    opacity = jnp.where(
        diffuse < 0.0, pre_trace + diffuse, jnp.maximum(pre_trace, diffuse)
    )
    opacity = jnp.where(visible, opacity, 0.0) * active

    rgb = (
        lights.color[:, None, None, :3]
        * lights.color[:, None, None, 3:4]
        * opacity[..., None]
    )
    out_rgb = jnp.sum(rgb, axis=0)
    out_a = jnp.sum(jnp.maximum(opacity, 0.0), axis=0)
    return jnp.concatenate([out_rgb, out_a[..., None]], axis=-1)


# Convenience jitted alias (see scan_shadows.scan_visibility_jit): one
# whole-graph, persistent-cache-eligible compile for eager callers.
accumulate_volumetric_lights_jit = jax.jit(
    accumulate_volumetric_lights,
    static_argnames=("quality", "shadowed", "shadow_detail"))
