"""Particle spawning.

Host side ports SpawnerBase's stochastic rate logic — min/max rate draw,
RateError accumulation, MaximumTotal clamp
(/root/reference/Illuminant/Particles/ParticleSpawner.cs:152-196) — and the
chunk/index bookkeeping of ParticleSpawning.cs collapses into a ring-cursor
range on the flat state array.

Device side ports Spawn_Stage1/2 (SpawnerCommon.fxh:119-190): per-slot
randomness -> position/velocity/life/category/color formulas -> post
matrices -> attribute discard. Randomness comes from jax.random per spawn
batch instead of the wrap-sampled randomness texture (behavioral
equivalence; evaluateRandomForIndex's modulo offsets were just a way to
decorrelate texture reads).

A spawner writes at most `spawn_max` slots per tick (static), masked by the
actual count — the jitted step has a fixed shape regardless of the
stochastic spawn count.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.pytree import pytree_dataclass
from ..core.pytree import named_scope
from .formula import (FORMULA_SPHERICAL, Formula1, Formula3, Formula4,
                      evaluate_formula)
from .state import ParticleState


@pytree_dataclass
class SpawnUniforms:
    """Configuration[9] + friends (SpawnerCommon.fxh:1-15,
    ParticleSpawner.cs:200-256)."""

    position_constants: jnp.ndarray  # (P, 4) xyz + life constant
    position_constant_count: jnp.ndarray  # () f32
    config: jnp.ndarray  # (9, 4): see pack order below
    formula_types: jnp.ndarray  # (4,)
    position_matrix: jnp.ndarray  # (4, 4) row-vector convention
    velocity_matrix: jnp.ndarray  # (4, 4)
    axis_mask: jnp.ndarray  # (3,)
    align_velocity_and_position: jnp.ndarray  # ()
    attribute_discard_threshold: jnp.ndarray  # ()
    # Polygon-path spawning (SpawnerCommon.fxh Spawn_Stage1 :136-155):
    # every `polygon_rate` particles advance one position constant, with
    # interpolation and optional loop closure; config row 8 = the
    # velocity-along-polygon formula (constant, scale, offset).
    polygon_rate: jnp.ndarray  # (); <= 0.05 disables
    polygon_loop: jnp.ndarray  # ()
    # Per-position-constant color multipliers — ones for plain spawners;
    # PatternSpawner's pixel colors (SpecialSpawners.cs
    # MultiplyColorConstant) ride here, multiplying the color formula of
    # particles spawned at that pixel.
    position_colors: jnp.ndarray = None  # (P, 4)


@named_scope("illuminant/particle_spawn")
def spawn(
    state: ParticleState,
    u: SpawnUniforms,
    count,  # traced int32 <= spawn_max
    key,
    spawn_max: int,
    sub_rings: int = 1,
) -> ParticleState:
    """Write up to spawn_max new particles at the ring cursor.

    `sub_rings` > 1 partitions the capacity into that many independent
    ring segments, each receiving count//sub_rings rows at a SHARED local
    cursor. Under a mesh sharding the capacity axis into `sub_rings`
    blocks, every segment's rolled window write is shard-LOCAL — the
    global ring's cross-shard window traffic disappears (the future
    layout named in parallel/mesh.py round 2). Requires spawn_max and
    capacity divisible by sub_rings; the device side rounds the spawn
    count down to a multiple of sub_rings — pass
    `Spawner.begin_tick(..., granularity=sub_rings)` on the host so the
    rounded remainder re-enters the rate-error accumulator instead of
    being silently dropped. sub_rings=1 is the reference-exact
    contiguous window."""
    n = state.capacity
    rel = jnp.arange(spawn_max, dtype=jnp.int32)
    if sub_rings > 1:
        assert spawn_max % sub_rings == 0 and n % sub_rings == 0, (
            "sub_rings must divide both spawn_max and capacity"
        )
        seg = spawn_max // sub_rings
        count = (count // sub_rings) * sub_rings
        per = count // sub_rings
        # Row j belongs to segment j // seg at local index j % seg; each
        # segment takes the first count/sub_rings of its rows.
        mask = (rel % seg) < per
        # Spawn ORDINAL among the kept rows: raw rel is non-contiguous
        # across segments (rel % seg < per), which would scramble the
        # position-constant cycling and polygon walk below — e.g. 4
        # constants with per=2 would starve constants 2 and 3 forever.
        rel_order = (rel // seg) * per + (rel % seg)
    else:
        mask = rel < count
        rel_order = rel

    k1, k2, k3 = jax.random.split(key, 3)
    random1 = jax.random.uniform(k1, (spawn_max, 4), jnp.float32)
    random2 = jax.random.uniform(k2, (spawn_max, 4), jnp.float32)
    random3 = jax.random.uniform(k3, (spawn_max, 4), jnp.float32)
    # AlignVelocityAndPosition (SpawnerCommon.fxh:114-117).
    random2 = jnp.where(
        u.align_velocity_and_position > 0.5,
        jnp.concatenate([random1[:, :2], random2[:, 2:]], axis=-1),
        random2,
    )

    # Position constant selection (Spawn_Stage1, fxh:136-155): either
    # cycle one constant per particle, or walk the polygon path at
    # `polygon_rate` particles per vertex with interpolation.
    p_count = jnp.maximum(u.position_constant_count, 1.0)
    # Wrap the cross-tick offset in INT32 before the float cast: the
    # wrap modulus is a multiple of the constant count (cycling stays
    # exact) and keeps relf far below f32's 2^24 integer limit — raw
    # total_spawned froze the polygon walk / constant cycle once the
    # system had spawned ~16M particles (the reference bounds the same
    # offset host-side, GetChunkSizeAndIndices). NOTE the offset is the
    # per-SYSTEM total (shared state): co-resident spawners advance each
    # other's phase — a known deviation from the reference's per-spawner
    # TotalSpawned, acceptable because phase only matters within one
    # spawner's own constants.
    p_ci = jnp.maximum(u.position_constant_count.astype(jnp.int32), 1)
    total_w = jnp.mod(state.total_spawned.astype(jnp.int32),
                      p_ci * 4096)
    relf = (rel_order + total_w).astype(jnp.float32)
    use_poly = u.polygon_rate > 0.05

    pos_f = relf / jnp.maximum(u.polygon_rate, 1e-3)
    pos_i = jnp.floor(pos_f)
    poly_t = pos_f - pos_i
    i1_loop = jnp.mod(pos_i, p_count)
    i2_loop = jnp.mod(pos_i + 1.0, p_count)
    i2_clamp = jnp.minimum(i1_loop + 1.0, p_count - 1.0)
    idx1 = jnp.where(use_poly, i1_loop, jnp.mod(relf, p_count))
    idx2 = jnp.where(
        use_poly,
        jnp.where(u.polygon_loop > 0.5, i2_loop, i2_clamp),
        idx1,
    )
    t = jnp.where(use_poly, poly_t, 0.0)[:, None]
    p1 = u.position_constants[idx1.astype(jnp.int32)]
    p2 = u.position_constants[idx2.astype(jnp.int32)]
    position_constant = p1 + (p2 - p1) * t
    towards_next = p2[:, :3] - p1[:, :3]

    zero = jnp.zeros_like(position_constant)
    # Spawn_Stage2 (fxh:157-190).
    temp_position = evaluate_formula(
        zero, position_constant, u.config[0], u.config[1], random1,
        u.formula_types[0], u.axis_mask,
    )
    new_position = _mul_point(temp_position, u.position_matrix)

    temp_velocity = evaluate_formula(
        temp_position, jnp.broadcast_to(u.config[2], temp_position.shape),
        u.config[3], u.config[4], random2, u.formula_types[1], u.axis_mask,
    )
    # Velocity along the polygon path (fxh:172-177): row 8 is a scalar
    # linear formula on random3.w.
    towards_len = jnp.sqrt(
        jnp.maximum(jnp.sum(towards_next**2, axis=-1, keepdims=True),
                    1e-12)
    )
    towards_speed = (
        u.config[8, 0]
        + (random3[:, 3:4] + u.config[8, 2]) * u.config[8, 1]
    )
    temp_velocity = jnp.concatenate(
        [
            temp_velocity[:, :3]
            + jnp.where(
                towards_len > 1e-4,
                towards_speed * towards_next / towards_len,
                0.0,
            ),
            temp_velocity[:, 3:4],
        ],
        axis=-1,
    )
    new_velocity = _mul_point(temp_velocity, u.velocity_matrix)

    attr_constant = jnp.broadcast_to(u.config[5], temp_position.shape)
    if u.position_colors is not None:
        # Pattern pixel color multiplies the color CONSTANT before the
        # formula evaluates (PatternSpawner.fx:70-74 MultiplyAttribute-
        # Constant) — random_scale/offset terms stay untinted.
        attr_constant = attr_constant * u.position_colors[
            idx1.astype(jnp.int32)
        ]
    new_attributes = evaluate_formula(
        zero, attr_constant,
        u.config[6], u.config[7], random3, u.formula_types[2], u.axis_mask,
    )

    mask = mask & (new_attributes[:, 3] >= u.attribute_discard_threshold)

    # The ring window [cursor, cursor+spawn_max) is contiguous modulo the
    # capacity, so the write is a masked merge of the ROLLED NEW ROWS —
    # one full-size roll per attribute instead of rolling the state out
    # and back, and no scatter. Masked rows
    # (count gate or attribute discard, SpawnerCommon.fxh:185-188) keep
    # their old values.
    if sub_rings > 1:
        block = n // sub_rings
        local_cursor = jnp.mod(state.write_cursor // sub_rings, block)
    if sub_rings > 1 and spawn_max > n:
        # Each segment's window self-overlaps its block (seg > block):
        # fall back to a scatter with drop semantics, like the
        # sub_rings=1 overflow path but with per-segment ring indices.
        # XLA applies duplicate-index .set updates in NONDETERMINISTIC
        # order — mask out rows superseded by a later row writing the
        # same slot so the NEWEST generation deterministically wins
        # (the reference ring overwrites sequentially).
        seg_id = rel // seg
        idx = seg_id * block + jnp.mod(local_cursor + rel % seg, block)
        m2 = mask.reshape(sub_rings, seg)
        sup = jnp.zeros_like(m2)
        for off in range(block, seg, block):
            sup = sup | jnp.pad(m2[:, off:], ((0, 0), (0, off)))
        keep = mask & ~sup.reshape(-1)
        safe_idx = jnp.where(keep, idx, n)

        def window_write(arr, new_rows):
            return arr.at[safe_idx].set(new_rows, mode="drop")
    elif sub_rings > 1:
        mask_seg = jnp.pad(
            mask.reshape(sub_rings, seg), ((0, 0), (0, block - seg))
        )
        mask_rolled = jnp.roll(mask_seg, local_cursor, axis=1).reshape(
            n
        )[:, None]

        def window_write(arr, new_rows):
            # (sub_rings, block, C): the roll is along the SHARD-LOCAL
            # axis, so a capacity-sharded mesh keeps it device-local.
            padded = jnp.pad(
                new_rows.reshape(sub_rings, seg, -1),
                ((0, 0), (0, block - seg), (0, 0)),
            )
            rolled = jnp.roll(padded, local_cursor, axis=1)
            return jnp.where(
                mask_rolled, rolled.reshape(n, -1), arr
            )
    elif spawn_max <= n:
        mask_pad = jnp.pad(mask, (0, n - spawn_max))
        mask_rolled = jnp.roll(mask_pad, state.write_cursor)[:, None]

        def window_write(arr, new_rows):
            padded = jnp.pad(new_rows, ((0, n - spawn_max), (0, 0)))
            return jnp.where(
                mask_rolled, jnp.roll(padded, state.write_cursor, axis=0),
                arr,
            )
    else:
        # spawn_max exceeds the ring: the window self-overlaps, so fall
        # back to a (cheap at this size) scatter with drop semantics.
        # Mask superseded rows (same-slot later writes) so the newest
        # generation deterministically wins — XLA's duplicate-index
        # .set order is nondeterministic.
        idx = jnp.mod(state.write_cursor + rel, n)
        sup = jnp.zeros_like(mask)
        for off in range(n, spawn_max, n):
            sup = sup | jnp.pad(mask[off:], (0, off))
        keep = mask & ~sup
        safe_idx = jnp.where(keep, idx, n)

        def window_write(arr, new_rows):
            return arr.at[safe_idx].set(new_rows, mode="drop")

    position = window_write(state.position, new_position)
    velocity = window_write(state.velocity, new_velocity)
    color = window_write(state.color, new_attributes)

    return state.replace(
        position=position,
        velocity=velocity,
        color=color,
        write_cursor=jnp.mod(state.write_cursor + count, n).astype(jnp.int32),
        total_spawned=state.total_spawned + count,
    )


from ..ops.coords import mul_point_rows as _mul_point  # noqa: E402


@dataclasses.dataclass
class Spawner:
    """Host spawner (SpawnerBase + Spawner, ParticleSpawner.cs)."""

    min_rate: float = 0.0  # particles per second
    max_rate: float = 0.0
    life: Formula1 = dataclasses.field(
        default_factory=lambda: Formula1(constant=1.0)
    )
    position: Formula3 = dataclasses.field(default_factory=Formula3)
    velocity: Formula3 = dataclasses.field(default_factory=Formula3)
    color: Formula4 = dataclasses.field(default_factory=Formula4)
    category: Formula1 = dataclasses.field(default_factory=Formula1)
    additional_positions: list = dataclasses.field(default_factory=list)
    axis_mask: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    align_velocity_and_position: bool = False
    maximum_total: Optional[int] = None
    position_post_matrix: Optional[np.ndarray] = None
    velocity_post_matrix: Optional[np.ndarray] = None
    alpha_discard_threshold: float = 0.0
    spawn_max: int = 8192  # static per-tick cap
    seed: int = 0
    # Polygon-path spawning (Spawner, ParticleSpawner.cs:262-419).
    polygon_rate: float = 0.0
    polygon_loop: bool = False
    velocity_along_polygon: Optional[Formula1] = None
    # RatePerPosition (ParticleSpawner.cs:286): the configured rate is a
    # PER-EMISSION-STREAM rate — it multiplies by CountScale (one stream
    # per additional position, +1 when the polygon loops back).
    rate_per_position: bool = True
    is_spawner = True

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self.rate_error = 0.0
        self.total_spawned = 0

    def reset(self):
        self.rate_error = 0.0
        self.total_spawned = 0
        # Re-seed so a reset system reproduces its original run (the
        # advanced generator state otherwise shifted every stochastic
        # rate draw after reset).
        self._rng = np.random.default_rng(self.seed)
        if hasattr(self, "read_cursor"):
            self.read_cursor = 0

    def carry_runtime_from(self, other: "Spawner"):
        """Adopt another spawner's runtime accumulators (rate error, RNG
        stream, spawn totals, feedback cursor) — used by the editor's
        live property-patch path so a mid-flight edit doesn't restart or
        stutter the emission stream."""
        self._rng = other._rng
        self.rate_error = other.rate_error
        self.total_spawned = other.total_spawned
        if hasattr(other, "read_cursor") and hasattr(self, "read_cursor"):
            self.read_cursor = other.read_cursor

    def count_scale(self) -> int:
        """CountScale (ParticleSpawner.cs:126-131, 301-305): with
        RatePerPosition the rate scales by the emission-stream count —
        additional positions + 1 when the polygon loops back; subclasses
        override (PatternSpawner scales by pixels per row/instance)."""
        if not self.rate_per_position:
            return 1
        return max(
            len(self.additional_positions)
            + (1 if self.polygon_loop else 0), 1)

    def begin_tick(self, now: float, dt: float,
                   granularity: int = 1) -> int:
        """BeginTick (ParticleSpawner.cs:152-196): stochastic count with
        error carry, scaled by CountScale (currentRate *= countScaler,
        :166; MaximumTotal scales the same way, :179).

        `granularity` > 1 rounds the count down to a multiple (the
        device-side `spawn(..., sub_rings=D)` only writes multiples of
        D); the remainder re-enters the rate-error accumulator so the
        long-run emission rate is exact."""
        min_rate = min(self.min_rate, self.max_rate)
        max_rate = self.max_rate
        scale = self.count_scale()
        current = (
            self._rng.uniform() * (max_rate - min_rate) + min_rate
        ) * scale * dt
        current += self.rate_error
        self.rate_error = 0.0
        if current < 1.0:
            self.rate_error = max(current, 0.0)
            count = 0
        else:
            count = int(current)
            self.rate_error = current - count
        finishing = False
        if self.maximum_total is not None:
            remaining = self.maximum_total * scale - self.total_spawned
            if count >= remaining:
                count = max(remaining, 0)
                self.rate_error = 0.0
                finishing = True
        if count > self.spawn_max:
            # Re-credit the clamped excess (the reference's EndTick adds
            # requested - actual back into RateError, :191-194) so a
            # rate above spawn_max/tick spreads over later ticks instead
            # of silently halving long-run emission.
            self.rate_error += count - self.spawn_max
            count = self.spawn_max
            finishing = False
        if granularity > 1:
            rem = count % granularity
            count -= rem
            if finishing:
                # The FINAL sub-granularity remainder of maximum_total
                # can never spawn (the device only writes multiples of
                # D) — retire it instead of ping-ponging through
                # rate_error forever.
                self.total_spawned += rem
            else:
                self.rate_error += rem
        self.total_spawned += count
        return count

    def estimate_maximum_life(self, now: float) -> float:
        """EstimateMaximumLifeForNewParticle (ParticleSpawner.cs:132-140)."""
        c, o, s = self.life.constant, self.life.offset, self.life.random_scale
        return max(c + o * s, c - o * s)

    def uniforms(self, now: float) -> SpawnUniforms:
        pos_constants = [(*self.position.constant,
                          self.life.constant)]
        for p in self.additional_positions:
            pos_constants.append((*p, self.life.constant))
        pc = np.asarray(pos_constants, np.float32)

        config = np.zeros((9, 4), np.float32)
        # Pack order (ParticleSpawner.cs:220-227).
        config[0] = (*self.position.random_scale, self.life.random_scale)
        config[1] = (*self.position.offset, self.life.offset)
        config[2] = (*self.velocity.constant, self.category.constant)
        config[3] = (*self.velocity.random_scale, self.category.random_scale)
        config[4] = (*self.velocity.offset, self.category.offset)
        config[5] = self.color.constant
        config[6] = self.color.random_scale
        config[7] = self.color.offset
        if self.velocity_along_polygon is not None:
            vap = self.velocity_along_polygon
            config[8, :3] = [vap.constant, vap.random_scale, vap.offset]

        identity = np.eye(4, dtype=np.float32)

        def post_matrix(m):
            """Static array OR animated Parameter<DynamicMatrix>: a
            BezierM evaluates at the CURRENT time each tick
            (ParticleSpawner.cs Position/VelocityPostMatrix are
            Parameter<DynamicMatrix> re-evaluated per frame)."""
            if m is None:
                return jnp.asarray(identity)
            from ..ops.bezier import BezierM, evaluate_bezier_matrix

            if isinstance(m, BezierM):
                return evaluate_bezier_matrix(m, now)
            return jnp.asarray(m, jnp.float32)

        return SpawnUniforms(
            position_constants=jnp.asarray(pc),
            position_constant_count=jnp.asarray(float(len(pos_constants)),
                                                jnp.float32),
            config=jnp.asarray(config),
            formula_types=jnp.asarray(
                [self.position.type, self.velocity.type, 0.0, 0.0],
                jnp.float32,
            ),
            position_matrix=post_matrix(self.position_post_matrix),
            velocity_matrix=post_matrix(self.velocity_post_matrix),
            axis_mask=jnp.asarray(self.axis_mask, jnp.float32),
            # The reference only honors the flag when BOTH formulas are
            # spherical (SetParameters: AlignVelocityAndPosition &&
            # Position.Circular && Velocity.Circular, Formula.cs:114) —
            # otherwise sharing random1.xy would just correlate linear
            # velocity randomness with position.
            align_velocity_and_position=jnp.asarray(
                1.0 if (self.align_velocity_and_position
                        and self.position.type == FORMULA_SPHERICAL
                        and self.velocity.type == FORMULA_SPHERICAL)
                else 0.0, jnp.float32
            ),
            attribute_discard_threshold=jnp.asarray(
                self.alpha_discard_threshold / 255.0, jnp.float32
            ),
            polygon_rate=jnp.asarray(self.polygon_rate, jnp.float32),
            polygon_loop=jnp.asarray(
                1.0 if self.polygon_loop else 0.0, jnp.float32
            ),
        )


# --------------------------------------------------------------------------
# Feedback spawning (SpecialSpawners.cs:265-442, SpawnParticles.fx
# PS_SpawnFeedback :55-118): consume another system's live particles as
# spawn inputs.


@pytree_dataclass
class FeedbackUniforms:
    base: SpawnUniforms
    source_index: jnp.ndarray  # () f32 — window start (FeedbackSourceIndex)
    instance_multiplier: jnp.ndarray  # ()
    source_velocity_factor: jnp.ndarray  # ()
    source_life_range: jnp.ndarray  # (2,)
    align_position_constant: jnp.ndarray  # ()
    multiply_attribute_constant: jnp.ndarray  # ()
    multiply_life: jnp.ndarray  # ()


def spawn_feedback(
    state: ParticleState,
    source: ParticleState,
    u: FeedbackUniforms,
    count,
    key,
    spawn_max: int,
) -> ParticleState:
    """PS_SpawnFeedback as a masked batch over spawn_max slots."""
    n = state.capacity
    b = u.base
    rel = jnp.arange(spawn_max, dtype=jnp.int32)
    idx = jnp.mod(state.write_cursor + rel, n)
    mask = rel < count

    # Source slot per new particle (fx:69-71).
    src_idx = jnp.mod(
        (rel.astype(jnp.float32) / jnp.maximum(u.instance_multiplier, 1.0)
         + u.source_index).astype(jnp.int32),
        source.capacity,
    )
    src_pos = source.position[src_idx]
    src_vel = source.velocity[src_idx]
    src_attr = source.color[src_idx]
    life_ok = (src_pos[:, 3] > u.source_life_range[0]) & (
        src_pos[:, 3] < u.source_life_range[1]
    )
    mask = mask & life_ok

    k1, k2, k3 = jax.random.split(key, 3)
    random1 = jax.random.uniform(k1, (spawn_max, 4), jnp.float32)
    random2 = jax.random.uniform(k2, (spawn_max, 4), jnp.float32)
    random3 = jax.random.uniform(k3, (spawn_max, 4), jnp.float32)
    random2 = jnp.where(
        b.align_velocity_and_position > 0.5,
        jnp.concatenate([random1[:, :2], random2[:, 2:]], axis=-1),
        random2,
    )

    position_constant = jnp.broadcast_to(
        b.position_constants[0], (spawn_max, 4)
    )
    position_constant = jnp.where(
        u.align_position_constant > 0.5,
        jnp.concatenate(
            [position_constant[:, :3] + src_pos[:, :3],
             position_constant[:, 3:4]], axis=-1,
        ),
        position_constant,
    )
    zero = jnp.zeros_like(position_constant)
    temp_position = evaluate_formula(
        zero, position_constant, b.config[0], b.config[1], random1,
        b.formula_types[0], b.axis_mask,
    )
    new_position = _mul_point(temp_position, b.position_matrix)
    new_position = jnp.where(
        u.multiply_life > 0.5,
        jnp.concatenate(
            [new_position[:, :3],
             new_position[:, 3:4] * src_pos[:, 3:4]], axis=-1,
        ),
        new_position,
    )

    temp_velocity = evaluate_formula(
        temp_position, jnp.broadcast_to(b.config[2], (spawn_max, 4)),
        b.config[3], b.config[4], random2, b.formula_types[1], b.axis_mask,
    )
    temp_velocity = temp_velocity + src_vel * u.source_velocity_factor
    new_velocity = _mul_point(temp_velocity, b.velocity_matrix)

    attribute_constant = jnp.broadcast_to(b.config[5], (spawn_max, 4))
    attribute_constant = jnp.where(
        u.multiply_attribute_constant > 0.5,
        attribute_constant * src_attr,
        attribute_constant,
    )
    new_attributes = evaluate_formula(
        temp_position, attribute_constant, b.config[6], b.config[7],
        random3, b.formula_types[2], b.axis_mask,
    )
    mask = mask & (new_attributes[:, 3] >= b.attribute_discard_threshold)

    safe_idx = jnp.where(mask, idx, n)
    return state.replace(
        position=state.position.at[safe_idx].set(new_position, mode="drop"),
        velocity=state.velocity.at[safe_idx].set(new_velocity, mode="drop"),
        color=state.color.at[safe_idx].set(new_attributes, mode="drop"),
        write_cursor=jnp.mod(state.write_cursor + count, n).astype(
            jnp.int32
        ),
        total_spawned=state.total_spawned + count,
    )


@dataclasses.dataclass
class FeedbackSpawner(Spawner):
    """Host feedback spawner (SpecialSpawners.cs:265-442). `source` is the
    live ParticleSystem consumed; the sliding window cursor advances by
    consumed count (SlidingWindow/WindowMargin semantics reduced to a ring
    cursor over the source capacity)."""

    source: object = None  # ParticleSystem
    instance_multiplier: int = 1
    source_velocity_factor: float = 0.0
    source_life_min: float = 0.0
    source_life_max: float = 1e9
    align_position_constant: bool = True
    multiply_attribute_constant: bool = True
    multiply_life: bool = False
    spawn_from_entire_window: bool = False

    def __post_init__(self):
        super().__post_init__()
        self.read_cursor = 0
        self.is_feedback = True

    def begin_tick(self, now: float, dt: float,
                   granularity: int = 1) -> int:
        """SpecialSpawners.cs:353-370: feedback counts round DOWN to a
        multiple of InstanceMultiplier ('we can't handle partial spawns
        from a source particle'); sub-multiple counts carry into the
        rate error instead of emitting partial instance groups."""
        count = super().begin_tick(now, dt, granularity)
        im = max(self.instance_multiplier, 1)
        if im > 1 and not self.spawn_from_entire_window:
            rounded = (count // im) * im
            if rounded < count:
                self.rate_error += count - rounded
                self.total_spawned -= count - rounded
                count = rounded
        return count

    def feedback_uniforms(self, now: float) -> FeedbackUniforms:
        return FeedbackUniforms(
            base=self.uniforms(now),
            source_index=jnp.asarray(float(self.read_cursor), jnp.float32),
            instance_multiplier=jnp.asarray(
                float(self.instance_multiplier), jnp.float32
            ),
            source_velocity_factor=jnp.asarray(
                self.source_velocity_factor, jnp.float32
            ),
            source_life_range=jnp.asarray(
                [self.source_life_min, self.source_life_max], jnp.float32
            ),
            align_position_constant=jnp.asarray(
                1.0 if self.align_position_constant else 0.0, jnp.float32
            ),
            multiply_attribute_constant=jnp.asarray(
                1.0 if self.multiply_attribute_constant else 0.0, jnp.float32
            ),
            multiply_life=jnp.asarray(
                1.0 if self.multiply_life else 0.0, jnp.float32
            ),
        )

    def advance_window(self, consumed: int, fallback_capacity=None):
        """Slide the read window. `fallback_capacity` serves SELF-
        feedback spelled source=None (the owning system passes its own
        capacity) — previously that spelling never advanced and re-
        consumed the same source slots every tick."""
        if consumed <= 0:
            # Zero-consumption ticks must not drift the window past
            # source particles that were never consumed.
            return
        if self.source is not None:
            cap = self.source.config.capacity
        elif fallback_capacity:
            cap = fallback_capacity
        else:
            return
        if self.spawn_from_entire_window:
            self.read_cursor = int(
                self._rng.integers(0, max(cap, 1))
            )
        else:
            # consumed is a whole number of instance groups (begin_tick
            # rounds); max(.., 1) matches the reference's
            # sourceCount = Max(spawnCount / InstanceMultiplier, 1)
            # (SpecialSpawners.cs:406) for the legacy partial case.
            self.read_cursor = (
                self.read_cursor
                + max(consumed // max(self.instance_multiplier, 1), 1)
            ) % cap


@dataclasses.dataclass
class PatternSpawner(Spawner):
    """Spawns particles from image pixels (SpecialSpawners.cs:15-263):
    pixel coordinates become position constants and pixel colors multiply
    the color formula. `image` is (H, W, 4) in [0, 1]; `divisor` thins the
    pixel grid; whole_spawn cycles through every pixel exactly once per
    pass."""

    image: object = None  # np.ndarray (H, W, 4)
    divisor: int = 1
    # NOTE deviation: the reference scales the pattern rate by
    # CountScale = ParticlesPerRow/ParticlesPerInstance
    # (SpecialSpawners.cs:125-135) because its UI rates are per-row;
    # here min/max_rate are ABSOLUTE particles/sec (count_scale
    # inherits the base additional-positions rule), which is the less
    # surprising contract for programmatic use.
    alpha_threshold: float = 0.05
    pixel_scale: float = 1.0

    def __post_init__(self):
        super().__post_init__()
        img = np.asarray(
            self.image if self.image is not None
            else np.ones((1, 1, 4), np.float32),
            np.float32,
        )
        h, w = img.shape[:2]
        ys, xs = np.mgrid[0:h:self.divisor, 0:w:self.divisor]
        cols = img[::self.divisor, ::self.divisor].reshape(-1, 4)
        keep = cols[:, 3] > self.alpha_threshold
        self._pattern_positions = np.stack(
            [
                xs.reshape(-1)[keep] * self.pixel_scale,
                ys.reshape(-1)[keep] * self.pixel_scale,
                np.zeros(keep.sum(), np.float32),
                np.zeros(keep.sum(), np.float32),
            ],
            axis=-1,
        ).astype(np.float32)
        self._pattern_colors = cols[keep]

    @property
    def pattern_size(self) -> int:
        return len(self._pattern_positions)

    def uniforms(self, now: float) -> SpawnUniforms:
        u = super().uniforms(now)
        if self.pattern_size == 0:
            return u
        base = np.asarray([(*self.position.constant, self.life.constant)],
                          np.float32)
        pc = self._pattern_positions + base
        # dataclasses-style replace: future SpawnUniforms fields flow
        # through instead of being silently reset here.
        return u.replace(
            position_constants=jnp.asarray(pc),
            position_constant_count=jnp.asarray(float(len(pc)),
                                                jnp.float32),
            position_colors=jnp.asarray(self._pattern_colors),
        )
