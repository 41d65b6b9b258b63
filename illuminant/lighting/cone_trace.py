"""Cone-traced soft shadows — THE hot loop of the lighting pipeline.

Port of /root/reference/Illuminant/Shaders/ConeTrace.fxh: sphere-trace from
the shaded point toward the light, shrinking visibility by the ratio of the
scene distance to the local cone radius, with a step budget and early-out
thresholds (fxh:141-191).

Array design: the per-pixel data-dependent `while` becomes a whole-tensor
`lax.while_loop` with an active mask — every live element advances together
and the loop exits when ALL elements are done (shadowed, reached the light,
or out of steps). Shadow rays from adjacent pixels are coherent, so the
max-live-step count stays near the per-pixel average in practice. This is
the exact-semantics oracle; the production path is the gather-free scan
reformulation in scan_shadows.py.

Constants (ConeTrace.fxh:1-29):
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.config import QualitySettings
from ..sdf.analytic import scene_sample
from ..sdf.volume import SdfVolume

MIN_CONE_RADIUS = 0.33
MAX_STEP_RAMP_WINDOW = 2.0
TRACE_INITIAL_OFFSET_PX = 0.5
FULLY_SHADOWED_THRESHOLD = 0.075
UNSHADOWED_THRESHOLD = 0.95
HACK_DISTANCE_OFFSET = 1.5


def _saturate(x):
    return jnp.clip(x, 0.0, 1.0)


def cone_trace(
    volume,
    light_center,
    light_radius,
    light_ramp_length,
    shaded_position,
    enable,
    quality: QualitySettings,
    raw: bool = False,
):
    """Visibility in [0, 1] of `light_center` from `shaded_position`.

    light_center/shaded_position: (..., 3); light_radius/ramp_length:
    broadcastable (...); enable: (...,) bool — disabled rays return 1.0
    (ConeTrace.fxh:190). All inputs broadcast together.

    raw=True returns the pre-threshold visibility min(vis, stepWindow)
    (fxh:175-180) so multi-ray variants like the line light's 3-trace
    average can apply the threshold/power once (LineLightCore.fxh:52-65).
    """
    if volume is None:
        return jnp.ones(jnp.broadcast_shapes(
            shaded_position.shape[:-1], enable.shape), jnp.float32)

    trace_vector = light_center - shaded_position
    trace_length = jnp.sqrt(
        jnp.maximum(jnp.sum(trace_vector * trace_vector, axis=-1), 1e-12)
    )
    direction = trace_vector / trace_length[..., None]
    # data.y: stop distance (fxh:46); data.x: start offset (fxh:47).
    end_offset = jnp.maximum(trace_length - light_radius, 1.0)

    # createTraceConfig (fxh:122-139).
    max_radius = jnp.clip(
        light_radius, MIN_CONE_RADIUS, quality.max_cone_radius
    )
    ramp_length = jnp.maximum(light_ramp_length, 16.0)
    growth_per_px = max_radius / ramp_length * quality.cone_growth_factor
    min_step = max(1.0, quality.min_step_size)
    long_step = quality.long_step_factor

    shape = jnp.broadcast_shapes(
        shaded_position.shape[:-1],
        light_center.shape[:-1],
        jnp.shape(enable),
        jnp.shape(light_radius),
    )
    offset0 = jnp.full(shape, TRACE_INITIAL_OFFSET_PX, jnp.float32)
    vis0 = jnp.ones(shape, jnp.float32)
    steps0 = jnp.full(shape, float(quality.max_step_count), jnp.float32)
    live0 = jnp.broadcast_to(enable, shape)

    origin = jnp.broadcast_to(shaded_position, shape + (3,))
    direction = jnp.broadcast_to(direction, shape + (3,))
    end_offset = jnp.broadcast_to(end_offset, shape)
    max_radius = jnp.broadcast_to(max_radius, shape)
    growth_per_px = jnp.broadcast_to(growth_per_px, shape)

    def cond(state):
        _, _, _, live = state
        return jnp.any(live)

    def body(state):
        offset, vis, steps, live = state
        steps = jnp.where(live, steps - 1.0, steps)

        # coneTraceAdvance (fxh:73-82): sample, shrink visibility, step.
        pos = origin + direction * offset[..., None]
        d = scene_sample(volume, pos)
        local_radius = jnp.minimum(
            growth_per_px * offset + MIN_CONE_RADIUS, max_radius
        )
        local_vis = (d + HACK_DISTANCE_OFFSET) / local_radius
        new_vis = jnp.minimum(vis, local_vis)
        new_offset = offset + jnp.maximum(jnp.abs(d) * long_step, min_step)

        vis = jnp.where(live, new_vis, vis)
        offset = jnp.where(live, new_offset, offset)

        # liveness = stepsRemaining * saturate(vis - threshold)
        #            * saturate(end - offset)   (fxh:81, 163-170)
        step_live = (
            _saturate(vis - FULLY_SHADOWED_THRESHOLD)
            * _saturate(end_offset - offset)
        ) > 0.0
        live = live & step_live & (steps > 0.0)
        return offset, vis, steps, live

    _, vis, steps, _ = jax.lax.while_loop(
        cond, body, (offset0, vis0, steps0, live0)
    )

    # Ramp visibility to 0 when the step budget ran out (fxh:175-180).
    step_window_vis = steps / MAX_STEP_RAMP_WINDOW
    visibility = jnp.minimum(vis, step_window_vis)

    if raw:
        return jnp.where(enable, visibility, 1.0)

    final = (
        _saturate(
            _saturate(visibility - FULLY_SHADOWED_THRESHOLD)
            / (UNSHADOWED_THRESHOLD - FULLY_SHADOWED_THRESHOLD)
        )
        ** quality.occlusion_to_opacity_power
    )
    return jnp.where(enable, final, 1.0)


# Convenience jitted alias (see scan_shadows.scan_visibility_jit): one
# whole-graph, persistent-cache-eligible compile for eager callers —
# tests use it as the march oracle at many scene/shape combos.
cone_trace_jit = jax.jit(cone_trace, static_argnames=("quality", "raw"))
