"""Particle force/modifier transforms.

Ports of /root/reference/Illuminant/Particles/Transforms.cs and their
shaders: FMA (FMA.fx), MatrixMultiply (MatrixMultiply.fx), Noise /
SpatialNoise (Noise.fx), Gravity (Gravity.fx), each restricted by an
optional area (ParticleTransform.cs TransformArea :35) and category filter.

Device functions are pure (positions, velocities) -> (positions,
velocities) over the whole SoA state; host config classes evaluate their
animatable parameters each tick into uniform pytrees. The per-system
transform LIST is static — the jitted step applies them in UpdateOrder,
exactly like the reference's pass sequencing (ParticleSystem.cs:791-856).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ..core.pytree import pytree_dataclass
from ..ops import noise as noise_ops
from ..ops import sdf_primitives
from .state import SystemUniforms, check_category_filter

MAX_ATTRACTORS = 16  # Gravity.fx:3


# --------------------------------------------------------------------------
# Area weighting (ParticleTransform.cs:294-325, FMA.fx:15-20)


@pytree_dataclass
class AreaUniforms:
    type: jnp.ndarray  # () int32; 0 = everywhere
    center: jnp.ndarray  # (3,)
    size: jnp.ndarray  # (3,)
    falloff: jnp.ndarray  # ()
    rotation: jnp.ndarray  # (4,) quaternion
    strength: jnp.ndarray  # ()

    @staticmethod
    def everywhere(strength=1.0) -> "AreaUniforms":
        return AreaUniforms(
            type=jnp.asarray(0, jnp.int32),
            center=jnp.zeros((3,), jnp.float32),
            size=jnp.ones((3,), jnp.float32),
            falloff=jnp.asarray(1.0, jnp.float32),
            rotation=jnp.asarray([0, 0, 0, 1], jnp.float32),
            strength=jnp.asarray(strength, jnp.float32),
        )


def area_weight(position_xyz, a: AreaUniforms):
    """computeWeight (FMA.fx:15-20); type None weights `strength`
    everywhere (evaluateNone returns 0 in the reference)."""
    d = sdf_primitives.evaluate_by_type(
        a.type, position_xyz, a.center, a.size, a.rotation
    )
    # Falloff clamps to a MINIMUM of 1 (ParticleTransform.cs:305
    # Math.Max(1, falloff)) — sub-unit falloffs are not sharper edges.
    w = (1.0 - jnp.clip(d / jnp.maximum(a.falloff, 1.0), 0.0, 1.0))
    w = jnp.where(a.type == 0, 1.0, w)
    return w * a.strength


@dataclasses.dataclass
class TransformArea:
    """Host-side area config (ParticleTransform.cs:35)."""

    type: int = 0  # sdf_primitives.TYPE_* (0 = everywhere)
    center: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    size: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    falloff: float = 1.0
    rotation_z: float = 0.0  # radians about z

    def uniforms(self, strength: float) -> AreaUniforms:
        h = self.rotation_z * 0.5
        return AreaUniforms(
            type=jnp.asarray(self.type, jnp.int32),
            center=jnp.asarray(self.center, jnp.float32),
            size=jnp.asarray(self.size, jnp.float32),
            falloff=jnp.asarray(self.falloff, jnp.float32),
            rotation=jnp.asarray(
                [0.0, 0.0, math.sin(h), math.cos(h)], jnp.float32
            ),
            strength=jnp.asarray(strength, jnp.float32),
        )


def _category_mask(velocity, filter_min_max):
    return check_category_filter(velocity[:, 3], filter_min_max)


# --------------------------------------------------------------------------
# FMA (Transforms.cs:16-50, FMA.fx)


@pytree_dataclass
class FMAUniforms:
    area: AreaUniforms
    position_add: jnp.ndarray  # (4,)
    position_multiply: jnp.ndarray  # (4,)
    velocity_add: jnp.ndarray  # (4,)
    velocity_multiply: jnp.ndarray  # (4,)
    cycles_per_second: jnp.ndarray  # (); < 0 = no time scaling
    category_filter: jnp.ndarray  # (2,)


def apply_fma(position, velocity, u: FMAUniforms, su: SystemUniforms):
    w = area_weight(position[:, :3], u.area)
    # t = weight * dt_ms / TimeDivisor with TimeDivisor = 1000/cps
    # (Transforms.cs:40) == weight * dt_seconds * cps.
    t = jnp.where(
        u.cycles_per_second >= 0.0,
        w * su.dt * u.cycles_per_second,
        w,
    )[:, None]
    live = (position[:, 3] > 0.0) & _category_mask(velocity, u.category_filter)
    live = live[:, None]

    new_pos = position + (position * u.position_multiply
                          + u.position_add - position) * t
    new_vel = velocity + (velocity * u.velocity_multiply
                          + u.velocity_add - velocity) * t
    # .w channels (life/category) preserved: multiply defaults 1, add 0 in
    # the packing (Transforms.cs:41-44 pads with w=1/w=0).
    return (
        jnp.where(live, new_pos, position),
        jnp.where(live, new_vel, velocity),
    )


@dataclasses.dataclass
class FMA:
    """Position/velocity multiply-add force (Transforms.cs:16)."""

    position_add: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    position_multiply: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    velocity_add: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    velocity_multiply: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    cycles_per_second: Optional[float] = 10.0
    strength: float = 1.0
    area: TransformArea = dataclasses.field(default_factory=TransformArea)
    category_filter: Tuple[float, float] = (-1e9, 1e9)
    is_spawner = False

    def uniforms(self, now: float) -> FMAUniforms:
        return FMAUniforms(
            area=self.area.uniforms(self.strength),
            position_add=jnp.asarray((*self.position_add, 0.0), jnp.float32),
            position_multiply=jnp.asarray(
                (*self.position_multiply, 1.0), jnp.float32
            ),
            velocity_add=jnp.asarray((*self.velocity_add, 0.0), jnp.float32),
            velocity_multiply=jnp.asarray(
                (*self.velocity_multiply, 1.0), jnp.float32
            ),
            cycles_per_second=jnp.asarray(
                -1.0 if self.cycles_per_second is None
                else self.cycles_per_second,
                jnp.float32,
            ),
            category_filter=jnp.asarray(self.category_filter, jnp.float32),
        )

    apply = staticmethod(apply_fma)


# --------------------------------------------------------------------------
# MatrixMultiply (Transforms.cs:52-71, MatrixMultiply.fx)


@pytree_dataclass
class MatrixMultiplyUniforms:
    area: AreaUniforms
    position_matrix: jnp.ndarray  # (4, 4) row-vector convention
    velocity_matrix: jnp.ndarray  # (4, 4)
    cycles_per_second: jnp.ndarray  # ()
    category_filter: jnp.ndarray  # (2,)


from ..ops.coords import mul_point_rows as _mul3  # noqa: E402


def apply_matrix_multiply(position, velocity, u: MatrixMultiplyUniforms,
                          su: SystemUniforms):
    w = area_weight(position[:, :3], u.area)
    t = jnp.where(
        u.cycles_per_second >= 0.0, w * su.dt * u.cycles_per_second, w
    )[:, None]
    live = (position[:, 3] > 0.0) & _category_mask(velocity, u.category_filter)
    live = live[:, None]
    new_pos = position + (_mul3(position, u.position_matrix) - position) * t
    new_vel = velocity + (_mul3(velocity, u.velocity_matrix) - velocity) * t
    return (
        jnp.where(live, new_pos, position),
        jnp.where(live, new_vel, velocity),
    )


@dataclasses.dataclass
class MatrixMultiply:
    position_matrix: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float32)
    )
    velocity_matrix: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float32)
    )
    cycles_per_second: Optional[float] = 10.0
    strength: float = 1.0
    area: TransformArea = dataclasses.field(default_factory=TransformArea)
    category_filter: Tuple[float, float] = (-1e9, 1e9)
    is_spawner = False

    def uniforms(self, now: float) -> MatrixMultiplyUniforms:
        return MatrixMultiplyUniforms(
            area=self.area.uniforms(self.strength),
            position_matrix=jnp.asarray(self.position_matrix, jnp.float32),
            velocity_matrix=jnp.asarray(self.velocity_matrix, jnp.float32),
            cycles_per_second=jnp.asarray(
                -1.0 if self.cycles_per_second is None
                else self.cycles_per_second,
                jnp.float32,
            ),
            category_filter=jnp.asarray(self.category_filter, jnp.float32),
        )

    apply = staticmethod(apply_matrix_multiply)


# --------------------------------------------------------------------------
# Gravity (Transforms.cs:309-372, Gravity.fx)

FALLOFF_PHYSICAL = 0  # 1/d^2 (ars.z < 0.5)
FALLOFF_LINEAR = 1  # ars.z in [0.5, 1.5)
FALLOFF_EXPONENTIAL = 2  # ars.z >= 1.5


@pytree_dataclass
class GravityUniforms:
    positions: jnp.ndarray  # (A, 3)
    radiuses: jnp.ndarray  # (A,)
    strengths: jnp.ndarray  # (A,)
    falloff_types: jnp.ndarray  # (A,) f32
    active: jnp.ndarray  # (A,) f32
    maximum_acceleration: jnp.ndarray  # ()
    category_filter: jnp.ndarray  # (2,)


def apply_gravity(position, velocity, u: GravityUniforms,
                  su: SystemUniforms):
    """Gravity.fx:12-61."""
    to_center = u.positions[None, :, :] - position[:, None, :3]  # (N, A, 3)
    dist_sq = jnp.sum(to_center * to_center, axis=-1)
    dist = jnp.sqrt(jnp.maximum(dist_sq, 1e-12))

    att_linear = 1.0 - jnp.clip(dist / jnp.maximum(u.radiuses, 1e-6), 0, 1)
    att_exp = att_linear * att_linear
    att_ramped = jnp.where(u.falloff_types >= 1.5, att_exp, att_linear)
    att_ramped = att_ramped * su.dt  # Gravity.fx:41 (dt/VelocityConstantScale)

    # Physical: no dt scaling (Gravity.fx:45 FIXME preserved).
    att_physical = 1.0 / jnp.maximum(dist_sq - u.radiuses, 0.001)

    attraction = jnp.where(u.falloff_types >= 0.5, att_ramped, att_physical)
    accel = (
        to_center / dist[..., None]
        * (attraction * u.strengths * u.active)[..., None]
    )
    accel = jnp.sum(accel, axis=1)  # (N, 3)

    max_accel = u.maximum_acceleration * su.dt
    alen = jnp.sqrt(jnp.maximum(jnp.sum(accel * accel, axis=-1), 1e-12))
    scale = jnp.minimum(1.0, max_accel / alen)
    accel = accel * scale[:, None]

    live = (position[:, 3] > 0.0) & _category_mask(velocity, u.category_filter)
    # Componentwise min with the scalar max velocity (Gravity.fx:58-60).
    new_v = jnp.minimum(su.maximum_velocity, velocity[:, :3] + accel)
    new_velocity = jnp.concatenate([new_v, velocity[:, 3:4]], axis=-1)
    return position, jnp.where(live[:, None], new_velocity, velocity)


@dataclasses.dataclass
class Attractor:
    position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    radius: float = 1.0
    strength: float = 1.0
    falloff_type: int = FALLOFF_LINEAR


@dataclasses.dataclass
class Gravity:
    attractors: list = dataclasses.field(default_factory=list)
    maximum_acceleration: float = 1e6
    category_filter: Tuple[float, float] = (-1e9, 1e9)
    is_spawner = False

    def uniforms(self, now: float) -> GravityUniforms:
        if len(self.attractors) > MAX_ATTRACTORS:
            raise ValueError(
                f"at most {MAX_ATTRACTORS} attractors (Gravity.fx:3)"
            )
        # Pad to a multiple of 2 (not the full 16): attractor count scales
        # per-particle work linearly and most scenes use 1-4.
        a = max(-(-len(self.attractors) // 2) * 2, 2)
        pos = np.zeros((a, 3), np.float32)
        rad = np.ones((a,), np.float32)
        stren = np.zeros((a,), np.float32)
        fall = np.zeros((a,), np.float32)
        act = np.zeros((a,), np.float32)
        for i, at in enumerate(self.attractors):
            pos[i] = at.position
            rad[i] = at.radius
            stren[i] = at.strength
            fall[i] = float(at.falloff_type)
            act[i] = 1.0
        return GravityUniforms(
            positions=jnp.asarray(pos),
            radiuses=jnp.asarray(rad),
            strengths=jnp.asarray(stren),
            falloff_types=jnp.asarray(fall),
            active=jnp.asarray(act),
            maximum_acceleration=jnp.asarray(
                self.maximum_acceleration, jnp.float32
            ),
            category_filter=jnp.asarray(self.category_filter, jnp.float32),
        )

    apply = staticmethod(apply_gravity)


# --------------------------------------------------------------------------
# Noise / SpatialNoise (Transforms.cs:133-307, Noise.fx)


@pytree_dataclass
class NoiseUniforms:
    area: AreaUniforms
    position_offset: jnp.ndarray  # (4,)
    position_minimum: jnp.ndarray  # (4,)
    position_scale: jnp.ndarray  # (4,)
    velocity_offset: jnp.ndarray  # (4,)
    velocity_minimum: jnp.ndarray  # (4,)
    velocity_scale: jnp.ndarray  # (4,)
    replace_old_velocity: jnp.ndarray  # ()
    cycles_per_second: jnp.ndarray  # ()
    frequency_lerp: jnp.ndarray  # ()
    randomness_offset: jnp.ndarray  # (2,)
    next_randomness_offset: jnp.ndarray  # (2,)
    space_scale: jnp.ndarray  # (2,) (SpatialNoise only)
    category_filter: jnp.ndarray  # (2,)


_NOISE_SEEDS = __import__("itertools").count(1)


def _noise_core(position, velocity, u: NoiseUniforms, su: SystemUniforms,
                random_p, random_v, apply_minimum: bool = True):
    w = area_weight(position[:, :3], u.area)
    t = jnp.where(
        u.cycles_per_second >= 0.0, w * su.dt * u.cycles_per_second, w
    )

    pd = random_p + u.position_offset
    vd = random_v + u.velocity_offset
    if apply_minimum:
        # PS_Noise only (Noise.fx:40-44); PS_SpatialNoise computes
        # (random + Offset) * Scale with no minimum clamp (fx:105-106).
        pd = jnp.sign(pd) * jnp.maximum(jnp.abs(pd), u.position_minimum)
        vd = jnp.sign(vd) * jnp.maximum(jnp.abs(vd), u.velocity_minimum)
    pd = pd * u.position_scale
    vd = vd * u.velocity_scale

    new_pos = position + pd * t[:, None]

    vnorm = velocity[:, :3] / jnp.sqrt(
        jnp.maximum(jnp.sum(velocity[:, :3] ** 2, axis=-1, keepdims=True),
                    1e-12)
    )
    v_replace = velocity[:, :3] + (vd[:, :3] - velocity[:, :3]) * w[:, None]
    v_add = velocity[:, :3] + vd[:, :3] * t[:, None]
    new_v = jnp.where(u.replace_old_velocity > 0.5, v_replace, v_add)
    new_v = new_v + vnorm * vd[:, 3:4]
    new_vel = jnp.concatenate([new_v, velocity[:, 3:4]], axis=-1)

    # Noise.fx applies regardless of life; only the category filter gates.
    live = _category_mask(velocity, u.category_filter)[:, None]
    return (
        jnp.where(live, new_pos, position),
        jnp.where(live, new_vel, velocity),
    )


def apply_noise(position, velocity, u: NoiseUniforms, su: SystemUniforms,
                field: noise_ops.RandomField, slot_xy):
    """Temporal noise (PS_Noise, Noise.fx:28-72): per-slot randomness
    interpolated between two random field offsets over the interval."""
    rp1 = noise_ops.point_sample(field, slot_xy, u.randomness_offset)
    rp2 = noise_ops.point_sample(field, slot_xy, u.next_randomness_offset)
    off = jnp.asarray([2.0, 1.0], jnp.float32)
    rv1 = noise_ops.point_sample(field, slot_xy + off, u.randomness_offset)
    rv2 = noise_ops.point_sample(
        field, slot_xy + off, u.next_randomness_offset
    )
    fl = u.frequency_lerp
    random_p = rp1 + (rp2 - rp1) * fl
    random_v = rv1 + (rv2 - rv1) * fl
    # Center to [-0.5, 0.5] like the reference's signed random textures? No:
    # the reference texture holds [0,1) and offsets shift it; preserved.
    return _noise_core(position, velocity, u, su, random_p, random_v)


def apply_spatial_noise(position, velocity, u: NoiseUniforms,
                        su: SystemUniforms, field: noise_ops.RandomField,
                        slot_xy):
    """PS_SpatialNoise (Noise.fx:74-116): position-indexed smooth
    randomness = a procedural vector field."""
    xy = position[:, :2]
    rate = u.space_scale
    rp1 = noise_ops.bilinear_sample(field, xy, u.randomness_offset, rate)
    rp2 = noise_ops.bilinear_sample(field, xy, u.next_randomness_offset, rate)
    off = jnp.asarray([2.0, 1.0], jnp.float32)
    rv1 = noise_ops.bilinear_sample(field, xy + off, u.randomness_offset,
                                    rate)
    rv2 = noise_ops.bilinear_sample(field, xy + off,
                                    u.next_randomness_offset, rate)
    fl = u.frequency_lerp
    random_p = rp1 + (rp2 - rp1) * fl
    random_v = rv1 + (rv2 - rv1) * fl
    return _noise_core(position, velocity, u, su, random_p, random_v,
                       apply_minimum=False)


@dataclasses.dataclass
class Noise:
    """Time-interpolated random force (Transforms.cs:133). Host tracks the
    randomness-offset interval cycling (Interval/offsets swap) like the
    reference's SetParameters."""

    # Defaults mirror the reference ctor (Transforms.cs:192-204):
    # Position {Offset -0.5, Scale 0}, Velocity {Offset -0.5, Scale 1},
    # Speed {Offset -0.5, Scale 0} riding the velocity arrays' w lane,
    # ReplaceOldVelocity true.
    interval_seconds: float = 1.0
    position_offset: Tuple[float, float, float, float] = (-0.5,) * 4
    position_minimum: Tuple[float, float, float, float] = (0.0,) * 4
    position_scale: Tuple[float, float, float, float] = (0.0,) * 4
    velocity_offset: Tuple[float, float, float, float] = (-0.5,) * 4
    velocity_minimum: Tuple[float, float, float, float] = (0.0,) * 4
    velocity_scale: Tuple[float, float, float, float] = (1.0,) * 3 + (0.0,)
    replace_old_velocity: bool = True
    cycles_per_second: Optional[float] = 10.0
    strength: float = 1.0
    area: TransformArea = dataclasses.field(default_factory=TransformArea)
    category_filter: Tuple[float, float] = (-1e9, 1e9)
    space_scale: Tuple[float, float] = (1.0, 1.0)
    spatial: bool = False
    is_spawner = False
    # Fresh randomness stream per instance (the reference seeds a new
    # Xoshiro per Noise, NextSeed static) — two default Noise transforms
    # must not cycle identical offsets.
    _rng: np.random.Generator = dataclasses.field(
        default_factory=lambda: np.random.default_rng(
            next(_NOISE_SEEDS)), repr=False
    )
    _offset_a: Tuple[float, float] = (0.0, 0.0)
    _offset_b: Tuple[float, float] = (37.0, 59.0)
    _last_cycle: int = -1

    def _maybe_cycle(self, now: float):
        if self.interval_seconds <= 0.01:
            # AutoCycleUV: interval <= 0.01 freezes the field (t = 0,
            # no cycling) — the reference's documented 'no changes'.
            return
        cycle = int(now / max(self.interval_seconds, 1e-6))
        if cycle != self._last_cycle:
            self._last_cycle = cycle
            self._offset_a = self._offset_b
            self._offset_b = (
                float(self._rng.uniform(0, 253)),
                float(self._rng.uniform(0, 127)),
            )

    def uniforms(self, now: float) -> NoiseUniforms:
        self._maybe_cycle(now)
        frac = (0.0 if self.interval_seconds <= 0.01
                else (now / self.interval_seconds) % 1.0)
        return NoiseUniforms(
            area=self.area.uniforms(self.strength),
            position_offset=jnp.asarray(self.position_offset, jnp.float32),
            position_minimum=jnp.asarray(self.position_minimum, jnp.float32),
            position_scale=jnp.asarray(self.position_scale, jnp.float32),
            velocity_offset=jnp.asarray(self.velocity_offset, jnp.float32),
            velocity_minimum=jnp.asarray(self.velocity_minimum, jnp.float32),
            velocity_scale=jnp.asarray(self.velocity_scale, jnp.float32),
            replace_old_velocity=jnp.asarray(
                1.0 if self.replace_old_velocity else 0.0, jnp.float32
            ),
            cycles_per_second=jnp.asarray(
                -1.0 if self.cycles_per_second is None
                else self.cycles_per_second,
                jnp.float32,
            ),
            frequency_lerp=jnp.asarray(frac, jnp.float32),
            randomness_offset=jnp.asarray(self._offset_a, jnp.float32),
            next_randomness_offset=jnp.asarray(self._offset_b, jnp.float32),
            # The shader rate is the RECIPROCAL of SpaceScale
            # (SetParameters: 1/scale — larger scale = larger, smoother
            # pattern).
            space_scale=1.0 / jnp.maximum(
                jnp.asarray(self.space_scale, jnp.float32), 1e-6),
            category_filter=jnp.asarray(self.category_filter, jnp.float32),
        )


def spatial_noise(**kwargs) -> Noise:
    return Noise(spatial=True, **kwargs)


# --------------------------------------------------------------------------
# VectorField force (VectorField.cs:10-51 + config-4 usage): a (H, W, 4)
# field sampled bilinearly at particle xy drives velocity. The reference
# uses vector-field textures for the VectorWarp material and editor tests;
# as a particle force it is the texture-driven analog of SpatialNoise.


@pytree_dataclass
class VectorFieldUniforms:
    area: AreaUniforms
    field: jnp.ndarray  # (H, W, 4)
    field_scale: jnp.ndarray  # (2,) world xy -> field texel scale
    field_offset: jnp.ndarray  # (2,)
    velocity_scale: jnp.ndarray  # (4,) xyz force scale + w: along-velocity
    replace_old_velocity: jnp.ndarray  # ()
    cycles_per_second: jnp.ndarray  # ()
    category_filter: jnp.ndarray  # (2,)


def apply_vector_field(position, velocity, u: VectorFieldUniforms,
                       su: SystemUniforms):
    from ..ops.noise import RandomField, bilinear_sample

    w = area_weight(position[:, :3], u.area)
    t = jnp.where(
        u.cycles_per_second >= 0.0, w * su.dt * u.cycles_per_second, w
    )
    sample = bilinear_sample(
        RandomField(data=u.field), position[:, :2], u.field_offset,
        u.field_scale,
    )
    # Field xy(z) channels are signed directions; scale per axis.
    delta = sample * u.velocity_scale
    vnorm = velocity[:, :3] / jnp.sqrt(
        jnp.maximum(jnp.sum(velocity[:, :3] ** 2, axis=-1, keepdims=True),
                    1e-12)
    )
    v_rep = velocity[:, :3] + (delta[:, :3] - velocity[:, :3]) * w[:, None]
    v_add = velocity[:, :3] + delta[:, :3] * t[:, None]
    new_v = jnp.where(u.replace_old_velocity > 0.5, v_rep, v_add)
    new_v = new_v + vnorm * delta[:, 3:4]
    new_vel = jnp.concatenate([new_v, velocity[:, 3:4]], axis=-1)
    live = ((position[:, 3] > 0.0)
            & _category_mask(velocity, u.category_filter))[:, None]
    return position, jnp.where(live, new_vel, velocity)


@dataclasses.dataclass
class VectorField:
    """Texture-driven force field."""

    field: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((8, 8, 4), np.float32)
    )
    field_scale: Tuple[float, float] = (1.0, 1.0)
    field_offset: Tuple[float, float] = (0.0, 0.0)
    velocity_scale: Tuple[float, float, float, float] = (1.0, 1.0, 0.0, 0.0)
    replace_old_velocity: bool = False
    cycles_per_second: Optional[float] = 10.0
    strength: float = 1.0
    area: TransformArea = dataclasses.field(default_factory=TransformArea)
    category_filter: Tuple[float, float] = (-1e9, 1e9)
    is_spawner = False

    def _device_field(self):
        # Convert once: uniforms() runs every tick and a fresh
        # jnp.asarray would re-upload the whole static field each frame.
        cached = getattr(self, "_field_dev", None)
        if cached is None or cached[0] is not self.field:
            cached = (self.field, jnp.asarray(self.field, jnp.float32))
            self._field_dev = cached
        return cached[1]

    def uniforms(self, now: float) -> VectorFieldUniforms:
        return VectorFieldUniforms(
            area=self.area.uniforms(self.strength),
            field=self._device_field(),
            field_scale=jnp.asarray(self.field_scale, jnp.float32),
            field_offset=jnp.asarray(self.field_offset, jnp.float32),
            velocity_scale=jnp.asarray(self.velocity_scale, jnp.float32),
            replace_old_velocity=jnp.asarray(
                1.0 if self.replace_old_velocity else 0.0, jnp.float32
            ),
            cycles_per_second=jnp.asarray(
                -1.0 if self.cycles_per_second is None
                else self.cycles_per_second, jnp.float32,
            ),
            category_filter=jnp.asarray(self.category_filter, jnp.float32),
        )


# --------------------------------------------------------------------------
# Sensor (Transforms.cs:374-486, CollectParticles.fx): counts live
# particles inside an area. The reference renders a count pass through an
# occlusion query and drains results on a thread pool; here it is one
# masked reduction over the SoA state.


@dataclasses.dataclass
class Sensor:
    """Analyzer transform: does not modify particles (IsAnalyzer)."""

    area: TransformArea = dataclasses.field(default_factory=TransformArea)
    category_filter: Tuple[float, float] = (-1e9, 1e9)
    is_spawner = False
    is_analyzer = True
    last_count: int = 0

    def uniforms(self, now: float) -> AreaUniforms:
        return self.area.uniforms(1.0)

    def measure(self, state) -> int:
        """Count live particles inside the area (device reduction)."""
        u = self.uniforms(0.0)
        w = area_weight(state.position[:, :3], u)
        # CollectParticles.fx:32: count life > 1 within any nonzero
        # falloff weight (> 0.01), not a half-weight cut.
        live = state.position[:, 3] > 1.0
        cat = check_category_filter(state.velocity[:, 3],
                                    jnp.asarray(self.category_filter))
        inside = w > 0.01
        self.last_count = int(jnp.sum((live & cat & inside).astype(
            jnp.int32)))
        return self.last_count


def _trs_matrix(pre_translate, pre_scale, rotation_xyz, post_translate,
                post_scale):
    """GeometricTransform matrix (Transforms.cs:81-107): row-vector
    pre-translate * pre-scale * rotation(YawPitchRoll) * post-scale *
    post-translate."""
    def translation(t):
        m = np.eye(4, dtype=np.float32)
        m[3, :3] = t
        return m

    def scale(s):
        m = np.eye(4, dtype=np.float32)
        m[0, 0] = m[1, 1] = m[2, 2] = s
        return m

    rx, ry, rz = rotation_xyz
    cy, sy = math.cos(ry), math.sin(ry)
    cp, sp_ = math.cos(rx), math.sin(rx)
    cr, sr = math.cos(rz), math.sin(rz)
    # Yaw (y) * Pitch (x) * Roll (z), XNA row-vector convention.
    m_y = np.asarray([[cy, 0, -sy, 0], [0, 1, 0, 0], [sy, 0, cy, 0],
                      [0, 0, 0, 1]], np.float32)
    m_x = np.asarray([[1, 0, 0, 0], [0, cp, sp_, 0], [0, -sp_, cp, 0],
                      [0, 0, 0, 1]], np.float32)
    m_z = np.asarray([[cr, sr, 0, 0], [-sr, cr, 0, 0], [0, 0, 1, 0],
                      [0, 0, 0, 1]], np.float32)
    rot = m_z @ m_x @ m_y
    return (translation(pre_translate) @ scale(pre_scale) @ rot
            @ scale(post_scale) @ translation(post_translate))


@dataclasses.dataclass
class GeometricTransform(MatrixMultiply):
    """TRS-decomposed matrix transform (Transforms.cs:73-131) — lowers to
    MatrixMultiply with host-computed matrices."""

    position_pre_translate: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    position_pre_scale: float = 1.0
    position_rotation: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    position_post_translate: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    position_post_scale: float = 1.0
    velocity_rotation: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    velocity_scale: float = 1.0

    def uniforms(self, now: float) -> MatrixMultiplyUniforms:
        self.position_matrix = _trs_matrix(
            self.position_pre_translate, self.position_pre_scale,
            self.position_rotation, self.position_post_translate,
            self.position_post_scale,
        )
        self.velocity_matrix = _trs_matrix(
            (0.0, 0.0, 0.0), 1.0, self.velocity_rotation, (0.0, 0.0, 0.0),
            self.velocity_scale,
        )
        return super().uniforms(now)
