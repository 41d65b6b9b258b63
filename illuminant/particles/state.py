"""Particle state: fixed-capacity SoA arrays + ring-cursor allocation.

Replaces the reference's chunk machinery — 64 chunks x ChunkSize^2 particles
in double-buffered render targets with pool recycling and liveness reaping
(/root/reference/Illuminant/Particles/ParticleSystem.cs:49-146,
ParticleEngine.cs:145-170, ParticleLiveness.cs). Here all of that reduces
to one (N, 4)-per-attribute state pytree updated functionally with buffer
donation: dead slots are masked (position.w <= 0, ParticleCommon.fxh:172)
and a ring write-cursor hands out spawn ranges, so "reaping" is free.

Channel semantics preserved (SURVEY.md §2.3):
  position.w = life (<= 0 dead); velocity.w = category / bounce-suppression
  counter; color = spawn attribute; render_color = post-ramp premultiplied
  color; render_data = (size, rotation, |velocity|, velocity.w).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core.pytree import pytree_dataclass, static_field


@pytree_dataclass
class ParticleState:
    position: jnp.ndarray  # (N, 4) xyz + life
    velocity: jnp.ndarray  # (N, 4) xyz + category
    color: jnp.ndarray  # (N, 4) spawn attribute
    render_color: jnp.ndarray  # (N, 4)
    render_data: jnp.ndarray  # (N, 4)
    write_cursor: jnp.ndarray  # () int32
    total_spawned: jnp.ndarray  # () int32

    @property
    def capacity(self) -> int:
        return self.position.shape[0]

    @staticmethod
    def empty(capacity: int) -> "ParticleState":
        n = capacity
        return ParticleState(
            position=jnp.zeros((n, 4), jnp.float32),
            velocity=jnp.zeros((n, 4), jnp.float32),
            color=jnp.ones((n, 4), jnp.float32),
            render_color=jnp.zeros((n, 4), jnp.float32),
            render_data=jnp.zeros((n, 4), jnp.float32),
            write_cursor=jnp.asarray(0, jnp.int32),
            total_spawned=jnp.asarray(0, jnp.int32),
        )

    def live_mask(self):
        return self.position[:, 3] > 0.0

    def live_count(self):
        """LiveCount (ParticleSystem.cs:293) — an on-device reduction
        instead of the GPU count-pass + readback (ParticleEngine.cs:224-400);
        that machinery was a GPU-API workaround (SURVEY.md §5.8)."""
        return jnp.sum(self.live_mask().astype(jnp.int32))


@pytree_dataclass
class SystemUniforms:
    """Per-update dynamic uniforms, Uniforms.ParticleSystem equivalent
    (ParticleCommon.fxh:29-37; Uniforms.cs:198-236). dt in SECONDS — the
    x1000 VelocityConstantScale packing was uniform-precision plumbing.

    global_settings: (dt_seconds, friction, maximum_velocity,
                      life_decay_per_second)
    collision_settings: (escape_velocity, bounce_velocity_multiplier,
                         collision_distance, collision_life_penalty)
    animation_and_rotation: (animation_rate_x, animation_rate_y,
                             velocity_rotation, z_to_y)
    """

    global_settings: jnp.ndarray  # (4,)
    collision_settings: jnp.ndarray  # (4,)
    animation_and_rotation: jnp.ndarray  # (4,)

    @staticmethod
    def make(dt=1.0 / 60, friction=0.0, maximum_velocity=16384.0,
             life_decay=1.0, escape_velocity=128.0,
             bounce_velocity_multiplier=0.0, collision_distance=0.33,
             collision_life_penalty=0.0, animation_rate=(0.0, 0.0),
             velocity_rotation=0.0, z_to_y=0.0) -> "SystemUniforms":
        return SystemUniforms(
            global_settings=jnp.asarray(
                [dt, friction, maximum_velocity, life_decay], jnp.float32
            ),
            collision_settings=jnp.asarray(
                [escape_velocity, bounce_velocity_multiplier,
                 collision_distance, collision_life_penalty], jnp.float32
            ),
            animation_and_rotation=jnp.asarray(
                [animation_rate[0], animation_rate[1], velocity_rotation,
                 z_to_y], jnp.float32
            ),
        )

    @property
    def dt(self):
        return self.global_settings[0]

    @property
    def friction(self):
        return self.global_settings[1]

    @property
    def maximum_velocity(self):
        return self.global_settings[2]

    @property
    def life_decay(self):
        return self.global_settings[3]


def apply_friction_and_maximum(velocity, uniforms: SystemUniforms):
    """applyFrictionAndMaximum (UpdateCommon.fxh:20-35) on (..., 3)."""
    l = jnp.sqrt(jnp.maximum(jnp.sum(velocity * velocity, axis=-1), 1e-20))
    max_v = uniforms.maximum_velocity
    clamped = jnp.minimum(l, max_v)
    friction = clamped * uniforms.friction
    new_l = jnp.clip(clamped - friction * uniforms.dt, 0.0, max_v)
    unit = velocity / l[..., None]
    result = unit * new_l[..., None]
    return jnp.where(l[..., None] <= 0.001, 0.0, result)


def check_category_filter(category, filter_min_max):
    """checkCategoryFilter (ParticleCommon.fxh:198-200)."""
    return (category >= filter_min_max[0]) & (category <= filter_min_max[1])
