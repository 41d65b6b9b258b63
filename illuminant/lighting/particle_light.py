"""Particle lights: a sphere-light template applied per live particle.

Port of /root/reference/Illuminant/Shaders/ParticleLight.fx and
ParticleLightSource (Lighting/LightSource.cs:466-505): each live particle
becomes an instance of the template sphere light, its color = particle
attribute color (un-premultiplied) x template color (fx:40-71), with
StippleFactor thinning the set (fx:27).

Array design: instead of instancing one quad per particle, a strided subset
of at most `max_lights` slots is taken from the particle SoA (static
slicing — no gathers) and evaluated as a batched SphereLights set through
the standard accumulator. The stipple factor maps to the subset fraction,
and brightness is compensated by the sampling ratio so total emitted light
energy is preserved (the reference's stipple does the same visually by
drawing a fraction of instances at full brightness — we normalize instead
so sparse sampling does not flicker).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from ..core.config import QualitySettings
from ..particles.state import ParticleState
from .environment import EnvironmentUniforms, SphereLights, SphereLightSource
from .gbuffer import GBuffer
from .sphere import accumulate_sphere_lights


@dataclasses.dataclass
class ParticleLightSource:
    """Host (LightSource.cs:466-505)."""

    template: SphereLightSource = dataclasses.field(
        default_factory=SphereLightSource
    )
    stipple_factor: float = 1.0
    max_lights: int = 64  # static evaluation budget (subset path)
    # Evaluation method: "auto" uses EXACT tiled light culling
    # (lighting/tiled_lights.py — every live particle contributes) for
    # the shadowless/unramped common case and the strided subset
    # otherwise; "subset"/"tiled" force a path.
    method: str = "auto"
    tile: int = 64  # tiled path: screen tile size (px)
    tile_capacity: int = 32  # tiled path: lights per tile
    # Tiled path: the scene's relief ceiling (max |relative_y|, world
    # units) — sizes the candidate window so lights reach tiles whose
    # elevated pixels sit in screen rows far from their world y. None =
    # one tile's worth (covers relief up to `tile` px at scale 1).
    max_relative_y: float | None = None


def subset_lights_from_particles(
    state: ParticleState,
    template: SphereLightSource,
    max_lights: int,
    energy_compensate: bool = True,
    stipple_factor: float = 1.0,
) -> SphereLights:
    """Strided subset of particle slots -> SphereLights SoA.

    `stipple_factor` thins the subset further (LightSource.cs:466+
    StippleFactor), with brightness compensation preserving total
    emitted energy."""
    n = state.capacity
    stride = max(n // max_lights, 1)
    pos = state.position[::stride][:max_lights]
    col = state.color[::stride][:max_lights]
    count = pos.shape[0]

    live = pos[:, 3] > 0.0
    alpha_ok = col[:, 3] > 0.0
    if stipple_factor < 1.0:
        from ..ops.coords import stipple_keep

        live = live & stipple_keep(count, stipple_factor)
    active = (live & alpha_ok).astype(jnp.float32)

    t_color = jnp.asarray(template.color, jnp.float32)
    # Un-premultiplied attribute color x template (ParticleLight.fx:40-71).
    color = col * t_color
    scale = float(stride) if energy_compensate else 1.0
    if energy_compensate and stipple_factor < 1.0:
        scale /= max(stipple_factor, 1e-3)
    color = jnp.concatenate(
        [color[:, :3], color[:, 3:4] * (template.opacity * scale)],
        axis=-1,
    )

    base = SphereLights.empty(count)
    props = jnp.broadcast_to(
        jnp.asarray(
            [
                template.radius,
                template.ramp_length,
                float(template.ramp_mode),
                1.0 if template.cast_shadows else 0.0,
            ],
            jnp.float32,
        ),
        (count, 4),
    )
    more = jnp.broadcast_to(
        jnp.asarray(
            [
                template.ambient_occlusion_radius,
                0.0,
                max(template.falloff_y_factor, 1e-3),
                template.ambient_occlusion_opacity,
            ],
            jnp.float32,
        ),
        (count, 4),
    )
    return base.replace(
        position=pos[:, :3],
        color=color,
        properties=props,
        more=more,
        active=active,
    )


def accumulate_particle_lights(
    volume,
    gbuffer: GBuffer,
    state: ParticleState,
    source: ParticleLightSource,
    env: EnvironmentUniforms,
    quality: QualitySettings,
    shadow_mode: str = "scan",
    return_diagnostics: bool = False,
):
    """-> (H, W, 4) additive HDR contribution; with
    return_diagnostics=True -> ((H, W, 4), dropped) where `dropped`
    (int32 scalar) counts tile-capacity overflow drops on the tiled
    path (emitters cluster by nature, so a dense cluster can overflow
    the per-tile light capacity and silently lose energy — read this to
    know; always 0 on the subset path, whose error mode is the strided
    sampling itself).

    Uses previous-frame particle state by convention (the reference reads
    usePreviousData to avoid a pipeline stall, LightingRenderer.cs:1138-43;
    functionally pass whichever state you have).

    Shadowless/unramped full-frame sources evaluate EXACTLY via tiled
    light culling (every live particle contributes; see
    tiled_lights.accumulate_sphere_lights_tiled, which also reports the
    per-tile capacity-overflow count for callers that need it);
    shadowed or ramped templates and windowed G-buffers use the strided
    subset."""
    tpl = source.template
    tpl_support = tpl.radius + (
        tpl.ramp_length if tpl.ramp_mode < 2 else 1.0
    )
    h, w = gbuffer.shape
    # Static density estimate: expected lights BINNED per tile if the
    # set spread uniformly over the frame — each tile bins every light
    # whose influence box touches it, a (2*inf + tile)^2 footprint, so
    # the per-tile count runs ~4x the per-pixel overlap. Tiled culling
    # suits DISCRETE sets (expected binned count well under the tile
    # capacity); a million-particle glow wash has ~100+ lights
    # genuinely overlapping every pixel, where the per-tile capacity
    # would drop energy and the strided subset's error is invisible (it
    # is a wash). The 1.5x margin absorbs moderate clustering;
    # pathological clustering still overflows — use
    # accumulate_sphere_lights_tiled directly to read the dropped
    # diagnostic when in doubt.
    rs = max(gbuffer.render_scale, 1e-6)
    inf_x = tpl_support * rs
    inf_y = tpl_support / max(tpl.falloff_y_factor, 1e-3) * rs
    exp_binned = (
        state.capacity
        * (2.0 * inf_x + source.tile) * (2.0 * inf_y + source.tile)
        / max(w * h, 1)
    )
    use_tiled = source.method == "tiled" or (
        source.method == "auto"
        and not tpl.cast_shadows
        and tpl.ramp_texture is None
        and gbuffer.pixel_origin is None
        and state.capacity <= 2048
        and exp_binned * 1.5 <= source.tile_capacity
    )
    if use_tiled:
        from .tiled_lights import accumulate_sphere_lights_tiled

        active = (state.position[:, 3] > 0.0) & (state.color[:, 3] > 0.0)
        brightness = 1.0
        if source.stipple_factor < 1.0:
            from ..ops.coords import stipple_keep

            active = active & stipple_keep(
                state.capacity, source.stipple_factor)
            # Match the subset path's energy-preserving convention (the
            # reference draws the kept fraction at full brightness; the
            # subset normalizes instead so sparse sampling does not
            # flicker — both paths must agree so the auto route never
            # changes scene brightness).
            brightness = 1.0 / max(source.stipple_factor, 1e-3)
        mry = (source.max_relative_y if source.max_relative_y is not None
               else source.tile / max(gbuffer.render_scale, 1e-6))
        img, diag = accumulate_sphere_lights_tiled(
            volume, gbuffer, state.position, state.color, active,
            tpl, env, tile=source.tile, capacity=source.tile_capacity,
            brightness_scale=brightness, max_relative_y=mry,
        )
        if return_diagnostics:
            return img, diag["dropped"]
        return img
    lights = subset_lights_from_particles(
        state, tpl, source.max_lights,
        stipple_factor=source.stipple_factor,
    )
    if not tpl.cast_shadows:
        # Host-static skip: the scan/march run full fixed-shape work even
        # when every per-light cast flag is false.
        shadow_mode = "none"
    img = accumulate_sphere_lights(
        volume, gbuffer, lights, env, quality,
        with_specular=False, shadow_mode=shadow_mode,
        with_ao=tpl.ambient_occlusion_radius > 0.0,
    )
    if return_diagnostics:
        return img, jnp.asarray(0, jnp.int32)
    return img


# Convenience jitted alias (see scan_shadows.scan_visibility_jit): one
# whole-graph, persistent-cache-eligible compile for eager callers.
# ParticleLightSource is a host-side mutable config (not a pytree), so
# the wrapper freezes it into a hashable static key per call.
def _rebuild_source(key) -> ParticleLightSource:
    (tpl_vals, stipple, max_lights, method, tile, tile_cap,
     max_rel_y) = key
    return ParticleLightSource(
        template=SphereLightSource(*tpl_vals),
        stipple_factor=stipple, max_lights=max_lights,
        method=method, tile=tile, tile_capacity=tile_cap,
        max_relative_y=max_rel_y,
    )


def _apl_keyed_py(volume, gbuffer, state, env, quality, source_key,
                  shadow_mode):
    return accumulate_particle_lights(
        volume, gbuffer, state, _rebuild_source(source_key), env,
        quality, shadow_mode,
    )


_apl_keyed = jax.jit(
    _apl_keyed_py,
    static_argnames=("quality", "source_key", "shadow_mode"),
)


def accumulate_particle_lights_jit(volume, gbuffer, state,
                                   source: ParticleLightSource, env,
                                   quality, shadow_mode="scan"):
    tpl = source.template
    if tpl.ramp_texture is not None:  # array field -> not freezable
        return accumulate_particle_lights(
            volume, gbuffer, state, source, env, quality, shadow_mode)
    key = (dataclasses.astuple(tpl), source.stipple_factor,
           source.max_lights, source.method, source.tile,
           source.tile_capacity, source.max_relative_y)
    return _apl_keyed(volume, gbuffer, state, env, quality=quality,
                      source_key=key, shadow_mode=shadow_mode)
