"""ParticleSystem: host orchestrator + the fused jitted step.

Mirrors the reference's ParticleSystem surface
(/root/reference/Illuminant/Particles/ParticleSystem.cs:338 — Update :634,
Spawn, Reset :518, LiveCount :293) and its pass sequencing: spawners first
(:725-741), then per-chunk non-spawn transforms in order, then the
integrator (:791-856). The whole sequence traces into ONE XLA program per
system (the transform list is static), state stays HBM-resident, and
double-buffering is just functional update with donated buffers.

The fixed-timestep accumulator (UpdatesPerSecond + error carry,
ParticleSystem.cs:634-665) runs host-side, calling the jitted tick 0..k
times per frame.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.noise import RandomField
from ..sdf.volume import SdfVolume
from . import spawner as spawner_mod
from . import transforms as tx
from .integrate import integrate, integrate_with_distance_field
from .render_data import RenderDataUniforms
from .state import ParticleState, SystemUniforms


@dataclasses.dataclass(frozen=True)
class ParticleSystemConfig:
    """Static system configuration (ParticleSystemConfiguration,
    ParticleConfiguration.cs:187-303, array-relevant subset; appearance
    fields live with the rasterizer)."""

    capacity: int = 1 << 20
    updates_per_second: float = 60.0
    maximum_update_delta: float = 1.0 / 20.0
    friction: float = 0.0
    maximum_velocity: float = 16384.0
    life_decay_per_second: float = 1.0
    z_to_y: float = 0.0
    # Render-Z controls (ParticleConfiguration.cs:282-287): screen_z =
    # dot(z_formula, (x, y, z, 1)) depth-orders alpha compositing;
    # size *= max(0, 1 + z * size_from_z). Fed to raster/render.py's
    # render_particles by ParticleSystem.render().
    z_formula: tuple = None
    size_from_z: float = 0.0
    # ParticleCollision (ParticleConfiguration.cs:8-40).
    collision_distance: float = 0.33
    collision_life_penalty: float = 0.0
    escape_velocity: float = 128.0
    bounce_velocity_multiplier: float = 0.0
    collision_maximum_z: float = 1e9
    # Sphere-trace substeps (MAX_STEP_COUNT=3,
    # UpdateParticleSystemWithDistanceField.fx:12). All particles pay for
    # every unrolled substep (branchless masking), but substeps
    # past the first only refine the backtrack of already-colliding
    # particles — 1 is a cheap quality knob (~2 dense SDF evals saved).
    collision_substeps: int = 3


def _slot_xy(capacity: int):
    """Map flat slot index -> the reference's 256-wide chunk texel grid
    (for randomness sampling parity, ParticleSystem.cs:49)."""
    i = jnp.arange(capacity, dtype=jnp.float32)
    return jnp.stack([i % 256.0, jnp.floor(i / 256.0)], axis=-1)


class ParticleSystem:
    """One particle system; transforms (incl. spawners) are fixed at
    construction (changing them rebuilds the jitted step, like the
    reference recompiling its pass list)."""

    def __init__(
        self,
        config: ParticleSystemConfig,
        transforms: Optional[List] = None,
        seed: int = 0,
        volume: Optional[SdfVolume] = None,
        render_data: Optional[RenderDataUniforms] = None,
    ):
        self.config = config
        self.transforms = list(transforms or [])
        self.volume = volume
        self.render_data = self._auto_rotation_gate(
            render_data or RenderDataUniforms.defaults())

        self.random_field = RandomField.create(jax.random.key(seed ^ 0x5EED))
        self.state = ParticleState.empty(config.capacity)
        self._base_key = jax.random.key(seed)
        self._tick_index = 0
        self._time = 0.0
        self._update_error = 0.0
        self._step = self._build_step()

    @staticmethod
    def _auto_rotation_gate(rd: RenderDataUniforms) -> RenderDataUniforms:
        """Auto-enable the (statically gated) velocity->rotation path if
        the host-side uniform is nonzero, so callers don't have to know
        about the gate — applied on construction AND live-patch."""
        try:
            if (not rd.use_velocity_rotation
                    and float(np.asarray(rd.velocity_rotation)) != 0.0):
                return rd.replace(use_velocity_rotation=True)
        except (TypeError, jax.errors.TracerArrayConversionError):
            pass  # traced value: caller controls the static flag
        return rd

    # -- step construction -------------------------------------------------

    @property
    def spawners(self):
        return [t for t in self.transforms if getattr(t, "is_spawner", False)]

    @property
    def modifiers(self):
        return [
            t for t in self.transforms if not getattr(t, "is_spawner", False)
        ]

    @staticmethod
    def _modifier_kind(t) -> str:
        """Canonical dispatch kind via isinstance (user SUBCLASSES of a
        transform dispatch like their base — an exact type-name table
        raised on e.g. class PulsingGravity(Gravity))."""
        if isinstance(t, tx.Sensor):
            return "Sensor"
        if isinstance(t, tx.FMA):
            return "FMA"
        if isinstance(t, tx.Gravity):
            return "Gravity"
        if isinstance(t, tx.VectorField):
            return "VectorField"
        if isinstance(t, tx.Noise):
            return "Noise"
        if isinstance(t, tx.MatrixMultiply):
            return "MatrixMultiply"
        raise TypeError(f"unknown transform kind {type(t).__name__}")

    def _build_step(self):
        cfg = self.config
        spawner_maxes = tuple(s.spawn_max for s in self.spawners)
        spawner_feedback = tuple(
            getattr(s, "is_feedback", False) for s in self.spawners
        )
        modifier_kinds = tuple(
            self._modifier_kind(t) for t in self.modifiers)
        modifier_spatial = tuple(
            getattr(t, "spatial", False) for t in self.modifiers
        )
        has_volume = self.volume is not None
        # Cache the jitted step by its STATIC structure: live-patching
        # with the same structure (the per-frame animated-model path)
        # must reuse the SAME jax.jit wrapper — a fresh closure per
        # patch would retrace/recompile the whole step every frame.
        key = (cfg, spawner_maxes, spawner_feedback, modifier_kinds,
               modifier_spatial, has_volume)
        cache = getattr(self, "_step_cache", None)
        if cache is None:
            cache = self._step_cache = {}
        if key in cache:
            return cache[key]

        @partial(jax.jit, donate_argnums=(0,))
        def step(state, su, rd, spawn_batches, modifier_uniforms,
                 random_field, volume, key):
            # Spawners first (ParticleSystem.cs:725-741).
            for i, (uni, count, src) in enumerate(spawn_batches):
                k = jax.random.fold_in(key, i)
                if spawner_feedback[i]:
                    # src None = SELF-feedback: read the in-step state
                    # (passing self.state separately would alias the
                    # donated input buffer).
                    state = spawner_mod.spawn_feedback(
                        state, state if src is None else src, uni, count,
                        k, spawner_maxes[i]
                    )
                else:
                    state = spawner_mod.spawn(
                        state, uni, count, k, spawner_maxes[i]
                    )

            # Non-spawn transforms in order (:800-817).
            pos, vel = state.position, state.velocity
            slot_xy = _slot_xy(cfg.capacity)
            for i, kind in enumerate(modifier_kinds):
                u = modifier_uniforms[i]
                if kind == "Sensor":
                    pass  # analyzer: measured host-side via .measure()
                elif kind == "FMA":
                    pos, vel = tx.apply_fma(pos, vel, u, su)
                elif kind == "MatrixMultiply":
                    pos, vel = tx.apply_matrix_multiply(pos, vel, u, su)
                elif kind == "Gravity":
                    pos, vel = tx.apply_gravity(pos, vel, u, su)
                elif kind == "VectorField":
                    pos, vel = tx.apply_vector_field(pos, vel, u, su)
                elif kind == "Noise":
                    if modifier_spatial[i]:
                        pos, vel = tx.apply_spatial_noise(
                            pos, vel, u, su, random_field, slot_xy
                        )
                    else:
                        pos, vel = tx.apply_noise(
                            pos, vel, u, su, random_field, slot_xy
                        )
                else:
                    raise TypeError(f"unknown transform kind {kind}")
            state = state.replace(position=pos, velocity=vel)

            # Integrator last (:834-855).
            if has_volume:
                state = integrate_with_distance_field(
                    state, su, rd, volume, cfg.collision_maximum_z,
                    substeps=cfg.collision_substeps,
                )
            else:
                state = integrate(state, su, rd)
            return state

        cache[key] = step
        return step

    # -- public surface -----------------------------------------------------

    def system_uniforms(self, dt: float) -> SystemUniforms:
        cfg = self.config
        return SystemUniforms.make(
            dt=dt,
            friction=cfg.friction,
            maximum_velocity=cfg.maximum_velocity,
            life_decay=cfg.life_decay_per_second,
            escape_velocity=cfg.escape_velocity,
            bounce_velocity_multiplier=cfg.bounce_velocity_multiplier,
            collision_distance=cfg.collision_distance,
            collision_life_penalty=cfg.collision_life_penalty,
            z_to_y=cfg.z_to_y,
        )

    def tick(self, dt: float):
        """Run exactly one fixed step of length dt."""
        su = self.system_uniforms(dt)
        now = self._time
        spawn_batches = []
        for s in self.spawners:
            count = s.begin_tick(now, dt)
            if getattr(s, "is_feedback", False):
                # None OR the owning system = self-feedback: the step
                # reads its own evolving state (passing self.state would
                # alias the donated input buffer).
                self_feed = s.source is None or s.source is self
                src = None if self_feed else s.source.state
                spawn_batches.append(
                    (s.feedback_uniforms(now),
                     jnp.asarray(count, jnp.int32), src)
                )
                s.advance_window(count,
                                 fallback_capacity=self.config.capacity)
            else:
                spawn_batches.append(
                    (s.uniforms(now), jnp.asarray(count, jnp.int32), None)
                )
        modifier_uniforms = [t.uniforms(now) for t in self.modifiers]
        key = jax.random.fold_in(self._base_key, self._tick_index)
        self.state = self._step(
            self.state, su, self.render_data, tuple(spawn_batches),
            tuple(modifier_uniforms), self.random_field, self.volume, key,
        )
        self._tick_index += 1
        self._time += dt

    def update(self, delta_time_seconds: float):
        """Frame update with fixed-timestep accumulation
        (ParticleSystem.cs:634-665)."""
        cfg = self.config
        if cfg.updates_per_second <= 0:
            self.tick(min(delta_time_seconds, cfg.maximum_update_delta))
            return
        step_dt = 1.0 / cfg.updates_per_second
        # Clamp the INCOMING delta only; the error accumulator must be
        # allowed to reach a full step or update rates slower than
        # 1/maximum_update_delta (e.g. 15 ups at the default 50 ms cap)
        # would saturate below one step and never tick at all.
        accumulated = (
            min(delta_time_seconds, cfg.maximum_update_delta)
            + self._update_error
        )
        steps = int(accumulated / step_dt)
        # Bound the carried error to one step (spiral-of-death guard).
        self._update_error = min(accumulated - steps * step_dt, step_dt)
        for _ in range(steps):
            self.tick(step_dt)

    def reset(self):
        """Clear (ParticleSystem.cs:518). A reset system reproduces its
        seeded run exactly: the tick index (the device RNG fold) rewinds
        and every spawner re-seeds its stochastic rate stream."""
        self.state = ParticleState.empty(self.config.capacity)
        self._time = 0.0
        self._update_error = 0.0
        self._tick_index = 0
        for s in self.spawners:
            s.reset()

    def patch(self, transforms=None, config=None, render_data=None):
        """LIVE-patch transforms/config without resetting state — the
        reference's property-edit path (Modeling/View.cs:199-264 patches
        live objects via reflection; only structural changes queue a
        reset, Controller.cs QueueReset).

        Particle state, RNG stream, tick index and spawn-rate error carry
        over; the step closure is rebuilt (property-only edits keep its
        static structure, so the jit cache is hit). Capacity changes are
        structural and must go through a rebuild instead."""
        if config is not None:
            if config.capacity != self.config.capacity:
                raise ValueError(
                    "capacity change is structural — rebuild the system"
                )
            self.config = config
        if transforms is not None:
            old_spawners = self.spawners
            self.transforms = list(transforms)
            # Carry spawner accumulators (rate error, window cursor) so a
            # rate tweak mid-flight doesn't stutter the emission stream —
            # but ONLY when the spawner list structure is unchanged
            # (same length, pairwise same types): a positional zip under
            # insertion/reorder would transplant total_spawned into the
            # wrong spawner (e.g. a fresh spawner adopting an exhausted
            # one's maximum_total count and never emitting).
            new_spawners = self.spawners
            if len(old_spawners) == len(new_spawners) and all(
                type(o) is type(n)
                for o, n in zip(old_spawners, new_spawners)
            ):
                for old, new in zip(old_spawners, new_spawners):
                    new.carry_runtime_from(old)
        if render_data is not None:
            self.render_data = self._auto_rotation_gate(render_data)
        self._step = self._build_step()

    @property
    def live_count(self) -> int:
        return int(self.state.live_count())

    def render(self, raster_config, **kwargs):
        """ParticleSystem.Render (ParticleSystem.cs:943): rasterize the
        current state with this system's configured appearance knobs —
        z_to_y projection, ZFormula depth ordering and SizeFromZ scaling
        (ParticleConfiguration.cs:282-287) — feeding raster/render.py's
        render_particles. Any kwarg overrides the config value."""
        from ..raster.render import render_particles

        cfg = self.config
        kwargs.setdefault("z_to_y", cfg.z_to_y)
        kwargs.setdefault("z_formula", cfg.z_formula)
        kwargs.setdefault("size_from_z", cfg.size_from_z)
        return render_particles(self.state, raster_config, **kwargs)


@dataclasses.dataclass
class BitmapDrawCall:
    """Host-side sprite draw call (the AutoReadback result shape,
    ParticleReadback.cs:21-167): position/size/rotation/color per live
    particle, optionally sorted."""

    position: object  # (N, 2) np.ndarray
    z: object  # (N,)
    size: object  # (N,)
    rotation: object  # (N,)
    color: object  # (N, 4) premultiplied
    category: object  # (N,)


def auto_readback(system: ParticleSystem, sort: bool = True,
                  z_to_y: Optional[float] = None) -> BitmapDrawCall:
    """AutoReadback (ParticleConfiguration.AutoReadback +
    ParticleReadback.cs): pull live particles to the host as a sprite
    list. One transfer of the SoA slices (the reference's threaded
    GetDataFast + CPU sort); `sort` orders back-to-front by screen y like
    SortedReadback. `z_to_y=None` uses the system's configured
    projection (matching render()'s contract)."""
    st = system.state
    if z_to_y is None:
        z_to_y = system.config.z_to_y
    live = np.asarray(st.live_mask())
    pos = np.asarray(st.position)[live]
    rd = np.asarray(st.render_data)[live]
    rc = np.asarray(st.render_color)[live]
    screen_y = pos[:, 1] - pos[:, 2] * z_to_y
    order = np.argsort(screen_y) if sort else np.arange(len(pos))
    return BitmapDrawCall(
        position=np.stack([pos[order, 0], screen_y[order]], axis=-1),
        z=pos[order, 2],
        size=rd[order, 0],
        rotation=rd[order, 1],
        color=rc[order],
        category=rd[order, 3],
    )
