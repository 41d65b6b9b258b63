"""Sphere-light per-pixel shading.

Port of the sphere light pixel pipeline:
  * falloff/normal opacity: LightCommon.fxh:154-210
    (computeSphereLightOpacity, computeNormalFactor)
  * ambient occlusion: AOCommon.fxh:1-20
  * core sequencing (prologue -> AO -> cone trace -> epilogue):
    SphereLightCore.fxh:58-158
  * specular: LightCommon.fxh:212-222
  * final accumulate color.rgb * color.a * opacity: SphereLight.fx:42-45

All lights of the family evaluate as one batched (L, H, W) tensor op
summed into the lightmap — replacing the reference's per-128-instance quad
draws with additive blending (LightingRenderer.cs:1149-1166).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.config import QualitySettings
from ..sdf.analytic import scene_sample
from ..sdf.volume import SdfVolume
from ..core.pytree import named_scope
from .cone_trace import cone_trace
from .environment import EnvironmentUniforms, SphereLights
from .gbuffer import GBuffer

# SphereLightCore.fxh:10-11.
SELF_OCCLUSION_HACK = 1.6
SHADOW_OPACITY_THRESHOLD = 0.75 / 255.0

# LightCommon.fxh:1-10.
DOT_OFFSET = 0.15
DOT_RAMP_RANGE = 0.15
DOT_EXPONENT = 0.85


def _saturate(x):
    return jnp.clip(x, 0.0, 1.0)


def compute_normal_factor(light_normal, shaded_normal,
                          offset=DOT_OFFSET, range_=DOT_RAMP_RANGE):
    """LightCommon.fxh:154-171; zero shaded normal -> 1 (no occlusion)."""
    d = jnp.sum(-light_normal * shaded_normal, axis=-1)
    factor = _saturate((d + offset) / range_) ** DOT_EXPONENT
    no_normal = jnp.all(shaded_normal == 0.0, axis=-1)
    return jnp.where(no_normal, 1.0, factor)


def compute_sphere_light_opacity(
    shaded_position, shaded_normal, light_center, light_properties,
    y_distance_factor, light_occlusion,
):
    """computeSphereLightOpacity (LightCommon.fxh:173-210).

    light_properties (..., 4) = radius, ramp_length, falloff_mode, _.
    """
    radius = light_properties[..., 0]
    ramp_length = jnp.maximum(light_properties[..., 1], 1e-6)
    falloff_mode = light_properties[..., 2]

    d3 = shaded_position - light_center
    d3 = jnp.stack(
        [d3[..., 0], d3[..., 1] * y_distance_factor, d3[..., 2]], axis=-1
    )
    distance = jnp.sqrt(jnp.maximum(jnp.sum(d3 * d3, axis=-1), 1e-12))
    distance_factor = 1.0 - _saturate((distance - radius) / ramp_length)

    # Far-behind-the-pixel occlusion (fxh:187-192).
    lo = jnp.maximum(light_occlusion, 1e-6)
    occl = 1.0 - _saturate(d3[..., 2] / lo)
    distance_factor = distance_factor * jnp.where(
        light_occlusion > 0.0, occl, 1.0
    )

    light_normal = d3 / distance[..., None]
    normal_factor = compute_normal_factor(light_normal, shaded_normal)

    # Falloff modes (fxh:197-203): 2 = none, 1 = exponential, 0 = linear.
    df_none = 1.0 - _saturate(distance - radius)
    df_exp = distance_factor * distance_factor
    distance_factor = jnp.where(
        falloff_mode >= 2.0,
        df_none,
        jnp.where(falloff_mode >= 1.0, df_exp, distance_factor),
    )
    normal_factor = jnp.where(falloff_mode >= 2.0, 1.0, normal_factor)

    # Inside the radius -> fully lit (fxh:208-209).
    return _saturate(
        normal_factor * distance_factor + _saturate(radius - distance)
    )


def compute_ao(volume, shaded_position, shaded_normal,
               ao_radius, ao_opacity, visible):
    """AOCommon.fxh:1-20: one field sample above the surface, squared ramp."""
    if volume is None:
        return jnp.ones(jnp.shape(ao_radius), jnp.float32)
    offset = jnp.stack(
        [
            jnp.zeros_like(ao_radius),
            jnp.zeros_like(ao_radius),
            shaded_normal[..., 2] * ao_radius,
        ],
        axis=-1,
    )
    d = scene_sample(volume, shaded_position + offset)
    clamped = jnp.clip(d, 0.0, ao_radius)
    r = 1.0 - _saturate(clamped / jnp.maximum(ao_radius, 1e-6))
    r = 1.0 - r * r
    result = (1.0 - ao_opacity) + r * ao_opacity
    return jnp.where((ao_radius >= 0.5) & visible, result, 1.0)


def compute_specularity(camera_position, shaded_position, shaded_normal,
                        light_center, power):
    """CalcSphereLightSpecularity (LightCommon.fxh:212-222)."""
    light_direction = shaded_position - light_center

    def norm(v):
        return v / jnp.sqrt(
            jnp.maximum(jnp.sum(v * v, axis=-1, keepdims=True), 1e-12)
        )

    h = norm(norm(camera_position - shaded_position) - light_direction)
    return _saturate(jnp.sum(h * shaded_normal, axis=-1)) ** jnp.maximum(
        power, 1e-6
    )


def compute_ao_p(volume, px, py, pz, nz, ao_radius, ao_opacity, visible,
                 pixel_grid=None):
    """Planar AOCommon.fxh:1-20 (one field sample above the surface).
    The sample offset follows +z * normal.z * radius like compute_ao.

    `pixel_grid` ((xs, ys) world vectors): voxel-field fast path — the
    probe xy anchors to the frame's pixel grid so the field lookup is a
    gather-free resampled-stack z-lerp (sampling.grid_stack). Exact for
    relative_y == 0 pixels (ground, billboard tops); height-volume FACE
    pixels probe at their screen y instead of the face's world y
    (bounded by the field's 1-Lipschitz property x |relative_y|;
    measured in tests/test_sampling_fast.py)."""
    if volume is None:
        return jnp.ones(jnp.broadcast_shapes(jnp.shape(px),
                                             jnp.shape(ao_radius)),
                        jnp.float32)
    from ..sdf.analytic import scene_sample_p
    from ..sdf.columns import ColumnField
    from ..sdf.volume import SdfVolume

    vol_field = volume.volume if isinstance(volume, ColumnField) \
        else volume
    if pixel_grid is not None and isinstance(vol_field, SdfVolume):
        from ..sdf.sampling import grid_stack, sample_stack_z

        xs, ys = pixel_grid
        stack = grid_stack(vol_field, xs, ys)
        d = sample_stack_z(vol_field, stack, xs, ys, pz + nz * ao_radius)
    else:
        d = scene_sample_p(volume, px, py, pz + nz * ao_radius)
    clamped = jnp.clip(d, 0.0, ao_radius)
    r = 1.0 - _saturate(clamped / jnp.maximum(ao_radius, 1e-6))
    r = 1.0 - r * r
    result = (1.0 - ao_opacity) + r * ao_opacity
    return jnp.where((ao_radius >= 0.5) & visible, result, 1.0)


@named_scope("illuminant/sphere_lights")
def accumulate_sphere_lights(
    volume,
    gbuffer: GBuffer,
    lights: SphereLights,
    env: EnvironmentUniforms,
    quality: QualitySettings,
    with_specular: bool = True,
    shadow_mode: str = "march",
    with_ao: bool = True,
    with_alpha: bool = True,
    scan_visibility_precomputed=None,
):
    """Shade all sphere lights against the G-buffer -> (H, W, 4) HDR add.

    `scan_visibility_precomputed` ((L, H, W)): a caller-supplied cone
    visibility (usually a slice of ONE fused radial scan shared by
    several light families — the scan's sequential column cost is
    per-PASS, so batching more lights into one call is nearly free;
    see scenes.py full-family frame). Implies the scan path.

    Equivalent to the instanced SphereLight.fx draws with additive blend:
    out.rgb = sum_l color_l.rgb * color_l.a * opacity_l (+ specular);
    out.a accumulates opacity so the albedo resolve's `saturate(light.a)`
    lerp behaves like the reference (Resolve.fx:56-59, light alpha written
    as 1 per lit pixel — here we accumulate opacity which saturates the
    same way for lit pixels).
    """
    # Planar pixel planes — the whole per-(light, pixel) prologue runs on
    # (L, H, W) component arrays; a (..., 3) minor dim would make every
    # stack/reduce over it a strided, padded intermediate.
    h, w = gbuffer.shape
    rs = gbuffer.render_scale
    ys = (jnp.arange(h, dtype=jnp.float32) + 0.5) / rs
    xs = (jnp.arange(w, dtype=jnp.float32) + 0.5) / rs
    wx = xs[None, None, :]  # (1, 1, W)
    wy = ys[None, :, None] + gbuffer.relative_y[None]  # (1, H, W)
    wz = gbuffer.z[None]
    normal = gbuffer.normal
    nx = normal[None, ..., 0]
    ny = normal[None, ..., 1]
    nz = normal[None, ..., 2]

    # Light axes broadcast as leading dim: (L, 1, 1).
    L = lights.capacity
    lc = lights.position[:, None, None, :]
    props = lights.properties[:, None, None, :]
    more = lights.more[:, None, None, :]
    color = lights.color  # (L, 4)
    active = lights.active[:, None, None]

    def lplane(v):  # (L,) -> (L, 1, 1)
        return v[:, None, None]

    radius = lplane(lights.properties[:, 0])
    ramp_length = jnp.maximum(lplane(lights.properties[:, 1]), 1e-6)
    falloff_mode = lplane(lights.properties[:, 2])
    y_factor = lplane(lights.more[:, 2])

    # computeSphereLightOpacity (LightCommon.fxh:173-210), planar.
    d3x = wx - lplane(lights.position[:, 0])
    d3y = (wy - lplane(lights.position[:, 1])) * y_factor
    d3z = wz - lplane(lights.position[:, 2])
    distance = jnp.sqrt(d3x * d3x + d3y * d3y + d3z * d3z + 1e-12)
    distance_factor = 1.0 - _saturate((distance - radius) / ramp_length)

    # Far-behind-the-pixel occlusion (fxh:187-192).
    lo = jnp.maximum(env.light_occlusion, 1e-6)
    occl = 1.0 - _saturate(d3z / lo)
    distance_factor = distance_factor * jnp.where(
        env.light_occlusion > 0.0, occl, 1.0
    )

    # Normal ramp (fxh:154-171): light normal = d3/distance.
    dot = -(d3x * nx + d3y * ny + d3z * nz) / distance
    normal_factor = _saturate(
        (dot + DOT_OFFSET) / DOT_RAMP_RANGE) ** DOT_EXPONENT
    no_normal = (nx == 0.0) & (ny == 0.0) & (nz == 0.0)
    normal_factor = jnp.where(no_normal, 1.0, normal_factor)

    # Falloff modes (fxh:197-203): 2 = none, 1 = exponential, 0 = linear.
    df_none = 1.0 - _saturate(distance - radius)
    df_exp = distance_factor * distance_factor
    distance_factor = jnp.where(
        falloff_mode >= 2.0,
        df_none,
        jnp.where(falloff_mode >= 1.0, df_exp, distance_factor),
    )
    normal_factor = jnp.where(falloff_mode >= 2.0, 1.0, normal_factor)

    # Inside the radius -> fully lit (fxh:208-209).
    distance_opacity = _saturate(
        normal_factor * distance_factor + _saturate(radius - distance)
    )  # (L, H, W)

    visible = (distance_opacity > 0.0) & (wx > -9999.0)

    # Fullbright pixels and shadow filtering (SphereLight.fx:25-31).
    not_fullbright = gbuffer.fullbright[None] < 0.5
    visible = visible & not_fullbright

    if with_ao:
        # AO only on upward-facing surfaces (SphereLightCore.fxh:77).
        ao_radius = more[..., 0] * jnp.maximum(0.0, nz)
        ao = compute_ao_p(
            volume, wx, wy, wz, nz, ao_radius, more[..., 3], visible,
            pixel_grid=(xs, ys),
        )
        pre_trace = distance_opacity * ao
    else:
        # Static skip: AO costs a full-res scene evaluation per light;
        # hosts gate it on any(light.ambient_occlusion_radius > 0).
        pre_trace = distance_opacity

    cast_shadows = props[..., 3] * gbuffer.enable_shadows[None]
    trace_enable = (
        visible
        & (cast_shadows > 0.0)
        & (pre_trace >= SHADOW_OPACITY_THRESHOLD)
        & (active > 0.0)
    )
    if scan_visibility_precomputed is not None:
        cone = jnp.where(
            trace_enable, scan_visibility_precomputed.astype(jnp.float32),
            1.0,
        )
    elif shadow_mode == "none":
        # Static skip when the HOST knows no light in the set casts
        # shadows (e.g. a shadowless ParticleLightSource template): both
        # the scan and the march run their full fixed-shape work even
        # with every trace_enable false, so the skip must be static.
        cone = jnp.ones_like(pre_trace)
    elif shadow_mode == "scan":
        # Fast gather-free path; `trace_enable` gating applied afterward
        # like the march's early-disable. Shadow-scale handling + the
        # normal-lifted endpoints live in the shared dispatch
        # (scan_shadows.scan_cone_visibility).
        from .scan_shadows import scan_cone_visibility

        vis = scan_cone_visibility(
            volume, gbuffer, lights.position, lights.properties[:, 0],
            lights.properties[:, 1], quality,
            light_active=lights.active,
        )
        cone = jnp.where(trace_enable, vis, 1.0)
    else:
        world_pos = gbuffer.world_position()
        cone = cone_trace(
            volume,
            lc,
            props[..., 0],
            props[..., 1],
            world_pos[None] + SELF_OCCLUSION_HACK * normal[None],
            trace_enable,
            quality,
        )

    opacity = pre_trace * cone
    opacity = jnp.where(visible, opacity, 0.0) * active  # epilogue discard

    if lights.ramp_texture is not None:
        # WithRamp epilogue (SphereLightCore.fxh:99-119): rgb from a ramp
        # texture sampled at (pre-trace opacity, angle-derived v), times
        # the cone term. Per-light flag mixes ramped and plain lights.
        from .projector import _sample_texture_bilinear

        angle = jnp.arctan2(wy - lplane(lights.position[:, 1]), d3x)
        orate = lights.ramp_offset_rate
        v = (angle + orate[:, None, None, 0]) * orate[:, None, None, 1]
        ramp_rgbs = []
        for li in range(L):
            ramp_rgbs.append(
                _sample_texture_bilinear(
                    lights.ramp_texture[li],
                    jnp.clip(pre_trace[li], 0.0, 1.0),
                    jnp.mod(v[li], 1.0),
                    jnp.float32(1.0),
                )
            )
        ramp_rgb = jnp.stack(ramp_rgbs, axis=0)  # (L, H, W, 3)
        lit = ramp_rgb * (cone * active)[..., None]
        lit = jnp.where(visible[..., None], lit, 0.0)
        has = orate[:, None, None, 2:3] > 0.5
        per_light_rgb = jnp.where(has, lit, opacity[..., None])
        rgb = (
            color[:, None, None, :3]
            * color[:, None, None, 3:4]
            * per_light_rgb
        )
        out_rgb = jnp.sum(rgb, axis=0)
    else:
        # sum_l color_l.rgb * color_l.a * opacity_l as ONE contraction
        # over the light axis — no (L, H, W, 3) materialization; bf16
        # operands (opacity in [0,1]) halve the contraction's HBM read.
        out_rgb = jnp.einsum(
            "lhw,lc->hwc", opacity.astype(jnp.bfloat16),
            (color[:, :3] * color[:, 3:4]).astype(jnp.bfloat16),
            preferred_element_type=jnp.float32,
        )

    if with_specular:
        # CalcSphereLightSpecularity (LightCommon.fxh:212-222), planar:
        # camera straight above the pixel at maximum_z + 0.01.
        spec = lights.specular_color_power
        # camera - shaded = (0, -relativeY, maximum_z + 0.01 - z).
        cy = -gbuffer.relative_y[None]
        cz = env.maximum_z + 0.01 - wz
        c_len = jnp.sqrt(cy * cy + cz * cz + 1e-12)
        hx = -d3x
        hy = cy / c_len - (wy - lplane(lights.position[:, 1]))
        hz = cz / c_len - d3z
        h_len = jnp.sqrt(hx * hx + hy * hy + hz * hz + 1e-12)
        sdot = _saturate((hx * nx + hy * ny + hz * nz) / h_len)
        specularity = sdot ** jnp.maximum(lplane(spec[:, 3]), 1e-6)
        out_rgb = out_rgb + jnp.einsum(
            "lhw,lc->hwc", specularity * opacity, spec[:, :3],
            preferred_element_type=jnp.float32,
        )

    if not with_alpha:
        # Callers compositing additively (no albedo resolve) never read
        # the accumulated-opacity channel; skip its reduction + concat.
        return out_rgb
    out_a = jnp.sum(opacity.astype(jnp.bfloat16), axis=0,
                    dtype=jnp.float32)
    return jnp.concatenate([out_rgb, out_a[..., None]], axis=-1)


# Convenience jitted alias (see scan_shadows.scan_visibility_jit): one
# whole-graph, persistent-cache-eligible compile for eager callers.
accumulate_sphere_lights_jit = jax.jit(
    accumulate_sphere_lights,
    static_argnames=("quality", "with_specular", "shadow_mode",
                     "with_ao", "with_alpha"))
