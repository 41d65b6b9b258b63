"""Particle integrators: plain Euler and SDF-collision.

Ports of /root/reference/Illuminant/Shaders/UpdateParticleSystem.fx
(PS_Update :9-38) and UpdateParticleSystemWithDistanceField.fx (PS_Update
:29-147): friction/max-velocity, life decay, and for the collision variant
up to MAX_STEP_COUNT=3 sphere-trace substeps with bounce / escape /
redirect states, normal estimation, bounce-delay counter in velocity.w,
and the collision life penalty.

Branch-heavy GPU code becomes branchless masked selects — every particle
computes all outcomes and picks one, which keeps the step one fused pass.
The math runs PLANAR (separate x/y/z component arrays): a (N, 3) minor dim
makes every per-axis op strided, so the whole step is expressed over
(N,) planes and repacked into the (N, 4) state arrays once at the end.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..sdf.analytic import (scene_normal_p, scene_sample_grad_p,
                            scene_sample_p)
from ..sdf.volume import SdfVolume
from ..core.pytree import named_scope
from .render_data import RenderDataUniforms, compute_render_data
from .state import ParticleState, SystemUniforms

# UpdateParticleSystemWithDistanceField.fx:12-25.
MAX_STEP_COUNT = 3
BOUNCE_DELAY = 3.0
NO_NORMAL_THRESHOLD = 0.33
INITIAL_ESCAPE_SPEED = 0.33
ESCAPE_SPEED_ACCELERATION = 1.1


def _len3(x, y, z, eps=1e-12):
    return jnp.sqrt(x * x + y * y + z * z + eps)


def _friction_max_p(vx, vy, vz, su: SystemUniforms, v_len=None):
    """applyFrictionAndMaximum (UpdateCommon.fxh:20-35), planar — exact
    mirror of state.apply_friction_and_maximum. Pass `v_len` when the
    caller already has |v| (saves a sqrt chain at particle count);
    returns the post-friction speed too for the same reason."""
    l = _len3(vx, vy, vz, 1e-20) if v_len is None else v_len
    max_v = su.maximum_velocity
    clamped = jnp.minimum(l, max_v)
    friction = clamped * su.friction
    new_l = jnp.clip(clamped - friction * su.dt, 0.0, max_v)
    m = jnp.where(l <= 0.001, 0.0, new_l / l)
    return vx * m, vy * m, vz * m, jnp.where(l <= 0.001, 0.0, new_l)


def integrate(state: ParticleState, su: SystemUniforms,
              rd: RenderDataUniforms) -> ParticleState:
    """Plain Euler (UpdateParticleSystem.fx PS_Update)."""
    pos = state.position
    vel = state.velocity
    dt = su.dt

    vx, vy, vz, _ = _friction_max_p(vel[:, 0], vel[:, 1], vel[:, 2], su)
    new_life = pos[:, 3] - su.life_decay * dt
    alive = new_life > 0.0

    was_alive = pos[:, 3] > 0.0
    keep = alive & was_alive
    kill = was_alive & ~keep

    def sel(new, old):
        return jnp.where(keep, new, jnp.where(was_alive, 0.0, old))

    new_pos = jnp.stack(
        [sel(pos[:, 0] + vx * dt, pos[:, 0]),
         sel(pos[:, 1] + vy * dt, pos[:, 1]),
         sel(pos[:, 2] + vz * dt, pos[:, 2]),
         sel(new_life, pos[:, 3])], axis=-1)
    new_vel = jnp.stack(
        [sel(vx, vel[:, 0]), sel(vy, vel[:, 1]), sel(vz, vel[:, 2]),
         sel(vel[:, 3], vel[:, 3])], axis=-1)
    del kill

    index = jnp.arange(state.capacity, dtype=jnp.int32)
    render_color, render_data = compute_render_data(
        new_pos, new_vel, state.color, index, rd
    )
    return state.replace(
        position=new_pos,
        velocity=new_vel,
        render_color=render_color,
        render_data=render_data,
    )


@named_scope("illuminant/particle_integrate")
def integrate_with_distance_field(
    state: ParticleState,
    su: SystemUniforms,
    rd: RenderDataUniforms,
    volume,
    maximum_z: float | jnp.ndarray = 1e9,
    substeps: int = MAX_STEP_COUNT,
) -> ParticleState:
    """SDF collision integrate (UpdateParticleSystemWithDistanceField.fx).

    `maximum_z` mirrors ParticleCollision.DistanceFieldMaximumZ
    (ParticleConfiguration.cs:8-40): particles above it ignore the field.
    `substeps` trades backtrack refinement for dense SDF evals (each
    unrolled substep is a full scene eval at particle count);
    travel is already capped by the initial sphere-trace step, so fewer
    substeps never tunnel — colliding particles just rest deeper.
    """
    pos = state.position
    vel = state.velocity
    dt = su.dt
    collision_distance = su.collision_settings[2]
    escape_velocity = su.collision_settings[0]
    bounce_mult = su.collision_settings[1]
    life_penalty = su.collision_settings[3]

    ox, oy, oz = pos[:, 0], pos[:, 1], pos[:, 2]
    new_life = pos[:, 3] - su.life_decay * dt
    was_alive = pos[:, 3] > 0.0
    alive = (new_life > 0.0) & was_alive

    v0x, v0y, v0z, v0w = vel[:, 0], vel[:, 1], vel[:, 2], vel[:, 3]
    v0len = _len3(v0x, v0y, v0z)
    ux, uy, uz = v0x / v0len, v0y / v0len, v0z / v0len
    # Post-friction velocity is a scalar multiple of v0, so its length
    # comes straight out of the friction clamp — no second sqrt chain.
    vx, vy, vz, v_new_len = _friction_max_p(v0x, v0y, v0z, su,
                                            v_len=v0len)
    scaled_len = v_new_len * dt

    # fx:63-70.
    initial_distance = scene_sample_p(volume, ox, oy, oz)
    above_field = oz > maximum_z
    initial_distance = jnp.where(above_field, 1e9, initial_distance)
    was_colliding = initial_distance < collision_distance
    travel = jnp.maximum(0.0, jnp.minimum(initial_distance, scaled_len))

    collided = jnp.zeros_like(was_colliding)
    escaping = jnp.zeros_like(was_colliding)
    cpx = jnp.zeros_like(ox)
    cpy = jnp.zeros_like(ox)
    cpz = jnp.zeros_like(ox)
    # Active substep mask (fx:66-71): wasColliding -> 1 step; zero travel
    # -> 0 steps.
    steps_left = jnp.where(
        was_colliding, 1, jnp.where(travel <= 0.001, 0, substeps)
    )

    # At ONE substep the final collision position cp is exactly this
    # substep's (tx, ty, tz) (every cp write below copies it), so the
    # fast normal can ride the step sample's own gradient rows — one
    # fused 1M-point pass instead of two (the gradient is measured free
    # on the column-map path, see scene_sample_grad_p).
    fused_normal = None
    for _ in range(substeps):  # fx:72-90, statically unrolled
        active = steps_left > 0
        tx = ox + travel * ux
        ty = oy + travel * uy
        tz = oz + travel * uz
        fused = (scene_sample_grad_p(volume, tx, ty, tz)
                 if substeps == 1 else None)
        if fused is not None:
            step_distance, fnx, fny, fnz = fused
            fused_normal = (fnx, fny, fnz)
        else:
            step_distance = scene_sample_p(volume, tx, ty, tz)
        step_distance = jnp.where(above_field, 1e9, step_distance)
        hit = step_distance < collision_distance

        newly = active & hit
        collided = jnp.where(newly, True, collided)
        cpx = jnp.where(newly, tx, cpx)
        cpy = jnp.where(newly, ty, cpy)
        cpz = jnp.where(newly, tz, cpz)
        escaping = jnp.where(active, step_distance > initial_distance,
                             escaping)

        backtrack = active & collided & ~escaping
        cpx = jnp.where(backtrack, tx, cpx)
        cpy = jnp.where(backtrack, ty, cpy)
        cpz = jnp.where(backtrack, tz, cpz)
        offset = jnp.clip(step_distance + collision_distance, 0.05, 16.0)
        travel = jnp.where(backtrack, jnp.maximum(0.0, travel - offset),
                           travel)

        # stepCount = 0 when not backtracking or travel exhausted (fx:85-89).
        steps_left = jnp.where(
            active & backtrack & (travel > 0.001), steps_left - 1, 0
        )

    # fx:92-139: resolve collision outcomes.
    bounce = v0w <= 0.0
    redirect = was_colliding & ~escaping
    needs_normal = collided & (bounce | redirect)
    if fused_normal is not None:
        nnx, nny, nnz = fused_normal
    else:
        nnx, nny, nnz = scene_normal_p(volume, cpx, cpy, cpz, fast=True)
    nx = jnp.where(needs_normal, nnx, 0.0)
    ny = jnp.where(needs_normal, nny, 0.0)
    nz = jnp.where(needs_normal, nnz, 0.0)
    escape_speed = jnp.minimum(su.maximum_velocity, escape_velocity)

    # Redirect: flee along the (xy-masked) normal (fx:103-116) — the
    # escape mask zeroes z (ESCAPE_MASK in the shader).
    r_len = _len3(nx, ny, jnp.zeros_like(nx))
    # Position-hash fallback direction to escape volume centers (fx:105-110)
    # — keyed on the slot index here instead of pixel xy.
    # Integer Weyl hash -> 2D direction without sin/cos (the reference
    # hashes pixel xy; any decorrelated unit-ish vector serves — the
    # redirect path normalizes by rd_len below).
    slot_i = jnp.arange(pos.shape[0], dtype=jnp.uint32)
    h1 = slot_i * jnp.uint32(2654435761)
    h2 = (slot_i + jnp.uint32(0x9E3779B9)) * jnp.uint32(2246822519)
    fbx = (h1 >> 16).astype(jnp.float32) / 32768.0 - 1.0
    fby = (h2 >> 16).astype(jnp.float32) / 32768.0 - 1.0
    fb_len = _len3(fbx, fby, jnp.zeros_like(fbx), 1e-6)
    fbx = fbx / fb_len
    fby = fby / fb_len
    no_norm = r_len < NO_NORMAL_THRESHOLD
    rdx = jnp.where(no_norm, fbx, nx)
    rdy = jnp.where(no_norm, fby, ny)
    # |rd| is r_len on the normal branch and exactly 1 on the (unit)
    # hash-fallback branch — reuse instead of a third sqrt chain.
    rd_len = jnp.where(no_norm, 1.0, jnp.maximum(r_len, 1e-6))
    r_speed = escape_speed * INITIAL_ESCAPE_SPEED
    r_vx = rdx / rd_len * r_speed
    r_vy = rdy / rd_len * r_speed
    r_vz = jnp.zeros_like(r_vx)
    r_px = ox + r_vx * dt
    r_py = oy + r_vy * dt
    r_pz = oz + r_vz * dt

    # Bounce: reflect (fx:117-128).
    ndotu = nx * ux + ny * uy + nz * uz
    bvx = -(2.0 * ndotu * (nx - ux))
    bvy = -(2.0 * ndotu * (ny - uy))
    bvz = -(2.0 * ndotu * (nz - uz))
    b_len = _len3(bvx, bvy, bvz)
    short = b_len < NO_NORMAL_THRESHOLD
    bdx = jnp.where(short, -ux, bvx / b_len)
    bdy = jnp.where(short, -uy, bvy / b_len)
    bdz = jnp.where(short, -uz, bvz / b_len)
    b_speed = jnp.minimum(su.maximum_velocity, v_new_len * bounce_mult)
    b_vx, b_vy, b_vz = bdx * b_speed, bdy * b_speed, bdz * b_speed

    # Escaping while colliding: accelerate out (fx:129-135).
    e_speed = jnp.maximum(v0len * ESCAPE_SPEED_ACCELERATION, escape_speed)
    e_vx, e_vy, e_vz = ux * e_speed, uy * e_speed, uz * e_speed

    # No collision (fx:136-139).
    n_px = ox + travel * ux
    n_py = oy + travel * uy
    n_pz = oz + travel * uz
    n_w = jnp.maximum(v0w - 1.0, 0.0)

    sel_redirect = collided & redirect
    sel_bounce = collided & ~redirect & bounce
    sel_escape = collided & ~redirect & ~bounce

    def pick(r, b, e, n):
        return jnp.where(
            sel_redirect, r,
            jnp.where(sel_bounce, b, jnp.where(sel_escape, e, n)),
        )

    out_vx = pick(r_vx, b_vx, e_vx, vx)
    out_vy = pick(r_vy, b_vy, e_vy, vy)
    out_vz = pick(r_vz, b_vz, e_vz, vz)
    out_px = pick(r_px, cpx, n_px, n_px)
    out_py = pick(r_py, cpy, n_py, n_py)
    out_pz = pick(r_pz, cpz, n_pz, n_pz)
    out_w = jnp.where(
        collided & (redirect | bounce), BOUNCE_DELAY,
        jnp.where(collided, v0w, n_w),
    )
    new_life = jnp.where(collided & ~redirect & bounce,
                         new_life - life_penalty, new_life)

    alive = alive & (new_life > 0.0)
    keep = alive

    def sel(new, old):
        return jnp.where(keep, new, jnp.where(was_alive, 0.0, old))

    new_pos = jnp.stack(
        [sel(out_px, pos[:, 0]), sel(out_py, pos[:, 1]),
         sel(out_pz, pos[:, 2]), sel(new_life, pos[:, 3])], axis=-1)
    new_vel = jnp.stack(
        [sel(out_vx, vel[:, 0]), sel(out_vy, vel[:, 1]),
         sel(out_vz, vel[:, 2]), sel(out_w, vel[:, 3])], axis=-1)

    index = jnp.arange(state.capacity, dtype=jnp.int32)
    render_color, render_data = compute_render_data(
        new_pos, new_vel, state.color, index, rd
    )
    return state.replace(
        position=new_pos,
        velocity=new_vel,
        render_color=render_color,
        render_data=render_data,
    )
