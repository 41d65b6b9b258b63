"""Particle engine: spawn, transforms, integrate, collision, liveness."""

import numpy as np

from illuminant.particles.formula import (
    FORMULA_SPHERICAL,
    Formula1,
    Formula3,
    Formula4,
)
from illuminant.particles.spawner import Spawner
from illuminant.particles.system import ParticleSystem, ParticleSystemConfig
from illuminant.particles import transforms as tx
from illuminant.ops import sdf_primitives as sp
from illuminant.sdf import volume as vol


def basic_spawner(rate=600.0, life=2.0, speed=20.0):
    return Spawner(
        min_rate=rate,
        max_rate=rate,
        life=Formula1(constant=life),
        position=Formula3(constant=(100.0, 100.0, 10.0)),
        velocity=Formula3.unit_normal(speed),
        color=Formula4(constant=(1.0, 0.5, 0.25, 1.0)),
        spawn_max=256,
    )


def test_spawn_rate_and_error_accumulation():
    cfg = ParticleSystemConfig(capacity=4096, updates_per_second=0.0,
                               life_decay_per_second=0.0)
    system = ParticleSystem(cfg, [basic_spawner(rate=100.0)])
    # 100/s at 60 fixed steps of 1/60s -> exactly 100 after 1s (the
    # RateError carry makes fractional-per-tick rates exact over time,
    # ParticleSpawner.cs:152-196).
    for _ in range(60):
        system.tick(1.0 / 60.0)
    assert system.live_count == 100


def test_spawn_positions_and_color():
    cfg = ParticleSystemConfig(capacity=1024, updates_per_second=0.0,
                               life_decay_per_second=0.0)
    system = ParticleSystem(cfg, [basic_spawner(rate=6000.0, speed=5.0)])
    system.tick(1.0 / 60.0)
    state = system.state
    live = np.asarray(state.live_mask())
    assert live.sum() == 100
    pos = np.asarray(state.position)[live]
    # Spawned particles integrate within the same tick (spawners run before
    # the integrator, ParticleSystem.cs:725-856): one step of drift at
    # speed 5 -> |dp| <= 5/60.
    np.testing.assert_allclose(pos[:, :3], [[100, 100, 10]] * 100, atol=0.1)
    col = np.asarray(state.color)[live]
    np.testing.assert_allclose(col, [[1, 0.5, 0.25, 1]] * 100, atol=1e-6)
    vel = np.asarray(state.velocity)[live]
    speeds = np.linalg.norm(vel[:, :3], axis=-1)
    # unit_normal(scale) draws magnitude ~ U[0, scale] (Formula.cs
    # SetToUnitNormal: RandomScale=1 -> circular = normal * rand.z * scale).
    assert speeds.max() <= 5.0 + 1e-3
    assert speeds.std() > 0.5, "speeds should be spread over [0, 5]"


def test_spawn_fixed_speed_shell():
    # Spherical formula with offset=s, random_scale=0 -> exact speed s
    # (SpawnerCommon.fxh:86 circular += randomNormal * offset).
    cfg = ParticleSystemConfig(capacity=1024, updates_per_second=0.0,
                               life_decay_per_second=0.0)
    spn = Spawner(
        min_rate=3000.0, max_rate=3000.0,
        life=Formula1(constant=10.0),
        position=Formula3(constant=(0.0, 0.0, 0.0)),
        velocity=Formula3(offset=(7.0, 7.0, 7.0), type=FORMULA_SPHERICAL),
        spawn_max=64,
    )
    system = ParticleSystem(cfg, [spn])
    system.tick(1.0 / 60.0)
    live = np.asarray(system.state.live_mask())
    vel = np.asarray(system.state.velocity)[live]
    speeds = np.linalg.norm(vel[:, :3], axis=-1)
    np.testing.assert_allclose(speeds, 7.0, atol=1e-3)


def test_life_decay_and_death():
    cfg = ParticleSystemConfig(capacity=512, updates_per_second=0.0,
                               life_decay_per_second=1.0)
    sp_ = basic_spawner(rate=3000.0, life=0.1)
    sp_.maximum_total = 50
    system = ParticleSystem(cfg, [sp_])
    system.tick(1.0 / 60.0)
    assert system.live_count == 50
    for _ in range(12):  # 12/60 s > 0.1 s of life
        system.tick(1.0 / 60.0)
    assert system.live_count == 0


def test_euler_integration_matches_oracle():
    cfg = ParticleSystemConfig(capacity=256, updates_per_second=0.0,
                               life_decay_per_second=0.0, friction=0.5)
    spn = Spawner(
        min_rate=60.0, max_rate=60.0,
        life=Formula1(constant=10.0),
        position=Formula3(constant=(0.0, 0.0, 0.0)),
        velocity=Formula3(constant=(10.0, 0.0, 0.0)),
        spawn_max=16,
    )
    system = ParticleSystem(cfg, [spn])
    dt = 1.0 / 60.0
    system.tick(dt)  # spawns 1 particle, integrates it once
    # Oracle: friction shortens speed each step: l -= l*friction*dt.
    v = 10.0
    p = 0.0
    v_after = max(v - v * 0.5 * dt, 0.0)
    p += v_after * dt
    state = system.state
    live = np.asarray(state.live_mask())
    assert live.sum() == 1
    got_p = np.asarray(state.position)[live][0]
    got_v = np.asarray(state.velocity)[live][0]
    np.testing.assert_allclose(got_v[0], v_after, rtol=1e-5)
    np.testing.assert_allclose(got_p[0], p, rtol=1e-5)
    for _ in range(10):
        system.tick(dt)
        v_after = max(v_after - v_after * 0.5 * dt, 0.0)
        p += v_after * dt
    live = np.asarray(system.state.live_mask())
    got_p = np.asarray(system.state.position)[live][0]
    np.testing.assert_allclose(got_p[0], p, rtol=1e-4)


def test_gravity_attractor_pulls():
    cfg = ParticleSystemConfig(capacity=256, updates_per_second=0.0,
                               life_decay_per_second=0.0)
    spn = Spawner(
        min_rate=60.0, max_rate=60.0,
        life=Formula1(constant=100.0),
        position=Formula3(constant=(0.0, 0.0, 0.0)),
        velocity=Formula3(constant=(0.0, 0.0, 0.0)),
        spawn_max=16,
    )
    grav = tx.Gravity(
        attractors=[tx.Attractor(position=(100.0, 0.0, 0.0), radius=500.0,
                                 strength=50.0,
                                 falloff_type=tx.FALLOFF_LINEAR)]
    )
    system = ParticleSystem(cfg, [spn, grav])
    for _ in range(30):
        system.tick(1.0 / 60.0)
    live = np.asarray(system.state.live_mask())
    pos = np.asarray(system.state.position)[live][0]
    vel = np.asarray(system.state.velocity)[live][0]
    assert vel[0] > 0.1, "should accelerate toward +x attractor"
    assert pos[0] > 0.0
    assert abs(pos[1]) < 1e-3 and abs(pos[2]) < 1e-3


def test_fma_velocity_add():
    cfg = ParticleSystemConfig(capacity=256, updates_per_second=0.0,
                               life_decay_per_second=0.0)
    spn = Spawner(
        min_rate=60.0, max_rate=60.0,
        life=Formula1(constant=100.0),
        position=Formula3(constant=(0.0, 0.0, 0.0)),
        velocity=Formula3(constant=(0.0, 0.0, 0.0)),
        spawn_max=16,
    )
    fma = tx.FMA(velocity_add=(0.0, 50.0, 0.0), cycles_per_second=1.0)
    system = ParticleSystem(cfg, [spn, fma])
    for _ in range(30):
        system.tick(1.0 / 60.0)
    live = np.asarray(system.state.live_mask())
    vel = np.asarray(system.state.velocity)[live][0]
    assert vel[1] > 0.1, "FMA should add +y velocity over time"


def test_noise_perturbs_velocity():
    cfg = ParticleSystemConfig(capacity=256, updates_per_second=0.0,
                               life_decay_per_second=0.0)
    spn = Spawner(
        min_rate=1200.0, max_rate=1200.0,
        life=Formula1(constant=100.0),
        position=Formula3(constant=(0.0, 0.0, 0.0)),
        velocity=Formula3(constant=(0.0, 0.0, 0.0)),
        spawn_max=64,
    )
    noise = tx.Noise(velocity_scale=(30.0, 30.0, 0.0, 0.0),
                     cycles_per_second=None)
    system = ParticleSystem(cfg, [spn, noise])
    for _ in range(5):
        system.tick(1.0 / 60.0)
    live = np.asarray(system.state.live_mask())
    vel = np.asarray(system.state.velocity)[live]
    speeds = np.linalg.norm(vel[:, :2], axis=-1)
    assert speeds.std() > 0.5, "noise should decorrelate velocities"


import pytest


@pytest.mark.parametrize("substeps", [3, 1])
def test_collision_keeps_particles_out_of_box(substeps):
    # Particles shot at a wall must not end up inside it — with the full
    # reference substep count AND the cheap single-substep quality knob
    # (travel is capped by the initial sphere-trace step, so fewer
    # substeps must never tunnel).
    sdf_config = vol.SdfVolumeConfig(
        virtual_width=256, virtual_height=256, virtual_depth=64,
        slice_count=16, resolution_scale=0.5,
    )
    field = vol.generate_volume(
        sdf_config,
        vol.SdfObstructions.from_lists(
            [sp.TYPE_BOX], [[128.0, 128.0, 32.0]], [[10.0, 100.0, 32.0]]
        ),
    )
    cfg = ParticleSystemConfig(
        capacity=512, updates_per_second=0.0, life_decay_per_second=0.0,
        collision_distance=1.0, bounce_velocity_multiplier=0.8,
        collision_substeps=substeps,
    )
    spn = Spawner(
        min_rate=6000.0, max_rate=6000.0,
        life=Formula1(constant=100.0),
        position=Formula3(constant=(60.0, 128.0, 32.0)),
        velocity=Formula3(constant=(120.0, 0.0, 0.0)),
        spawn_max=128,
        # Bound the burst so the ring cursor never wraps and overwrites
        # the bounced particles we assert on.
        maximum_total=400,
    )
    system = ParticleSystem(cfg, [spn], volume=field)
    for _ in range(60):  # 1 second: wall at x=118 reached in ~0.5 s
        system.tick(1.0 / 60.0)
    live = np.asarray(system.state.live_mask())
    pos = np.asarray(system.state.position)[live]
    assert live.sum() > 0
    # Box spans x in [118, 138]: nobody may be inside it (allow the
    # collision_distance shell).
    inside = (pos[:, 0] > 119.5) & (pos[:, 0] < 136.5)
    assert inside.sum() == 0, f"{inside.sum()} particles inside the wall"
    # With bounce, some particles should be moving back (-x).
    vel = np.asarray(system.state.velocity)[live]
    assert (vel[:, 0] < -1.0).any(), "expected bounced particles"


def test_ring_cursor_wraps():
    cfg = ParticleSystemConfig(capacity=128, updates_per_second=0.0,
                               life_decay_per_second=0.0)
    system = ParticleSystem(cfg, [basic_spawner(rate=6000.0)])
    for _ in range(3):
        system.tick(1.0 / 60.0)  # 100/tick > capacity 128 after 2 ticks
    assert system.live_count == 128  # saturated, oldest overwritten
    assert int(system.state.total_spawned) == 300


def test_reset():
    cfg = ParticleSystemConfig(capacity=256, updates_per_second=0.0)
    system = ParticleSystem(cfg, [basic_spawner(rate=600.0)])
    system.tick(1.0 / 60.0)
    assert system.live_count > 0
    system.reset()
    assert system.live_count == 0
    assert int(system.state.total_spawned) == 0


def test_update_fixed_timestep_accumulation():
    cfg = ParticleSystemConfig(capacity=1024, updates_per_second=60.0,
                               life_decay_per_second=0.0)
    system = ParticleSystem(cfg, [basic_spawner(rate=60.0)])
    # 0.5s of wall time in odd increments -> 30 fixed ticks -> 30 particles.
    t = 0.0
    while t < 0.5 - 1e-9:
        system.update(0.0137)
        t += 0.0137
    assert abs(system.live_count - 30) <= 2


def test_pattern_spawner_spawns_image_pixels():
    from illuminant.particles.spawner import PatternSpawner

    img = np.zeros((4, 4, 4), np.float32)
    img[1, 2] = [1.0, 0.0, 0.0, 1.0]
    img[3, 0] = [0.0, 1.0, 0.0, 1.0]
    spn = PatternSpawner(
        image=img, min_rate=600.0, max_rate=600.0,
        life=Formula1(constant=10.0),
        position=Formula3(constant=(100.0, 200.0, 0.0)),
        spawn_max=32, pixel_scale=10.0,
    )
    assert spn.pattern_size == 2
    cfg = ParticleSystemConfig(capacity=256, updates_per_second=0.0,
                               life_decay_per_second=0.0)
    system = ParticleSystem(cfg, [spn])
    system.tick(1.0 / 60.0)
    live = np.asarray(system.state.live_mask())
    pos = np.asarray(system.state.position)[live]
    # Positions cycle through the two pattern pixels offset by the base.
    want = {(120.0, 210.0), (100.0, 230.0)}
    got = {(round(p[0]), round(p[1])) for p in pos}
    assert got == want, got


def test_feedback_spawner_inherits_source():
    from illuminant.particles.spawner import FeedbackSpawner

    src_cfg = ParticleSystemConfig(capacity=256, updates_per_second=0.0,
                                   life_decay_per_second=0.0)
    src_spawner = Spawner(
        min_rate=1200.0, max_rate=1200.0,
        life=Formula1(constant=10.0),
        position=Formula3(constant=(50.0, 60.0, 0.0)),
        velocity=Formula3(constant=(7.0, 0.0, 0.0)),
        spawn_max=64,
    )
    source = ParticleSystem(src_cfg, [src_spawner])
    source.tick(1.0 / 60.0)
    assert source.live_count == 20

    fb = FeedbackSpawner(
        source=source,
        min_rate=600.0, max_rate=600.0,
        life=Formula1(constant=5.0),
        source_velocity_factor=1.0,
        align_position_constant=True,
        spawn_max=32,
    )
    cfg = ParticleSystemConfig(capacity=256, updates_per_second=0.0,
                               life_decay_per_second=0.0)
    system = ParticleSystem(cfg, [fb])
    system.tick(1.0 / 60.0)
    live = np.asarray(system.state.live_mask())
    assert live.sum() == 10
    pos = np.asarray(system.state.position)[live]
    vel = np.asarray(system.state.velocity)[live]
    # Inherited source position (plus one tick of drift at speed 7).
    np.testing.assert_allclose(pos[:, 1], 60.0, atol=0.5)
    assert np.all(np.abs(pos[:, 0] - 50.0) < 1.0)
    np.testing.assert_allclose(vel[:, 0], 7.0, atol=0.1)


def test_sensor_counts_particles_in_area():
    spn = Spawner(
        min_rate=6000.0, max_rate=6000.0,
        life=Formula1(constant=10.0),
        position=Formula3(constant=(50.0, 50.0, 0.0),
                          random_scale=(100.0, 0.0, 0.0)),
        spawn_max=128,
    )
    sensor = tx.Sensor(
        area=tx.TransformArea(type=sp.TYPE_BOX, center=(50.0, 50.0, 0.0),
                              size=(30.0, 30.0, 30.0), falloff=0.1)
    )
    cfg = ParticleSystemConfig(capacity=512, updates_per_second=0.0,
                               life_decay_per_second=0.0)
    system = ParticleSystem(cfg, [spn, sensor])
    system.tick(1.0 / 60.0)
    total = system.live_count
    inside = sensor.measure(system.state)
    assert 0 < inside < total
    pos = np.asarray(system.state.position)
    live = np.asarray(system.state.live_mask())
    want = int(((np.abs(pos[live, 0] - 50.0) <= 30.5)).sum())
    assert abs(inside - want) <= 2


def test_rasterize_sized_particles():
    from illuminant.raster.particles import rasterize_additive
    import jax.numpy as jnp

    cfg = ParticleSystemConfig(capacity=16, updates_per_second=0.0,
                               life_decay_per_second=0.0)
    system = ParticleSystem(cfg, [])
    st = system.state
    pos = np.zeros((16, 4), np.float32)
    pos[0] = [32.5, 32.5, 0.0, 5.0]  # texel center
    rc = np.zeros((16, 4), np.float32)
    rc[0] = [1.0, 1.0, 1.0, 1.0]
    rd = np.zeros((16, 4), np.float32)
    rd[0, 0] = 5.0  # size
    st = st.replace(position=jnp.asarray(pos),
                    render_color=jnp.asarray(rc),
                    render_data=jnp.asarray(rd))
    img = np.asarray(rasterize_additive(st, 64, 64, footprint=7))
    assert img[32, 32, 0] > 0.9  # center fully covered
    assert img[32, 34, 0] > 0.3  # inside the disc
    assert img[32, 38, 0] == 0.0  # outside
    # Rough disc symmetry.
    np.testing.assert_allclose(img[30, 32, 0], img[34, 32, 0], atol=0.15)
    total = img[..., 0].sum()
    assert 10.0 < total < 40.0  # ~pi r^2 = 19.6 coverage


def test_polygon_path_spawning():
    # Particles walk the polygon path, interpolating between vertices,
    # with velocity along the path (SpawnerCommon.fxh:136-155, 172-177).
    spn = Spawner(
        min_rate=600.0, max_rate=600.0,
        life=Formula1(constant=10.0),
        position=Formula3(constant=(0.0, 0.0, 0.0)),
        additional_positions=[(100.0, 0.0, 0.0), (100.0, 100.0, 0.0)],
        polygon_rate=5.0,  # 5 particles per edge step
        polygon_loop=False,
        velocity_along_polygon=Formula1(constant=20.0),
        spawn_max=32,
        # This test pins the path-walk mechanics at exactly 10 spawns;
        # RatePerPosition (the reference default, tested separately)
        # would scale the rate by the position count.
        rate_per_position=False,
    )
    cfg = ParticleSystemConfig(capacity=256, updates_per_second=0.0,
                               life_decay_per_second=0.0)
    system = ParticleSystem(cfg, [spn])
    system.tick(1.0 / 60.0)  # 10 spawns
    live = np.asarray(system.state.live_mask())
    pos = np.asarray(system.state.position)[live]
    vel = np.asarray(system.state.velocity)[live]
    assert live.sum() == 10
    # First 5 interpolate (0,0)->(100,0): x = 0,20,40,60,80; y = 0.
    xs = np.sort(pos[:, 0])
    assert xs[0] < 5.0 and xs[-1] > 95.0
    near_first_edge = pos[np.abs(pos[:, 1]) < 1.0]
    assert len(near_first_edge) >= 5
    # Velocity points along the current edge at speed ~20.
    speeds = np.linalg.norm(vel[:, :3], axis=-1)
    np.testing.assert_allclose(speeds, 20.0, atol=0.5)


def test_auto_readback_sprite_list():
    from illuminant.particles.system import auto_readback

    cfg = ParticleSystemConfig(capacity=256, updates_per_second=0.0,
                               life_decay_per_second=0.0)
    system = ParticleSystem(cfg, [basic_spawner(rate=1200.0)])
    system.tick(1.0 / 60.0)
    calls = auto_readback(system, sort=True)
    assert len(calls.position) == system.live_count == 20
    assert calls.color.shape == (20, 4)
    assert np.all(np.diff(calls.position[:, 1]) >= 0)  # sorted by y


def test_animated_velocity_post_matrix():
    """Parameter<DynamicMatrix> spawner post-matrix: a BezierM velocity post-matrix evaluates at the tick time, so
    the injection angle animates across frames."""
    import jax.numpy as jnp
    from illuminant.ops.bezier import (DynamicMatrix,
                                           pack_bezier_matrix)
    from illuminant.particles.formula import Formula3
    from illuminant.particles.spawner import Spawner

    bm = pack_bezier_matrix(
        [DynamicMatrix.from_components(angle=0.0),
         DynamicMatrix.from_components(angle=90.0)],
        min_value=0.0, max_value=1.0,
    )
    sp = Spawner(
        min_rate=60.0, max_rate=60.0,
        velocity=Formula3(constant=(10.0, 0.0, 0.0)),
        velocity_post_matrix=bm,
    )
    m0 = np.asarray(sp.uniforms(0.0).velocity_matrix)
    m1 = np.asarray(sp.uniforms(1.0).velocity_matrix)
    v = np.asarray([10.0, 0.0, 0.0, 1.0], np.float32)
    v0 = v @ m0
    v1 = v @ m1
    np.testing.assert_allclose(v0[:2], [10.0, 0.0], atol=1e-5)
    np.testing.assert_allclose(v1[:2], [0.0, 10.0], atol=1e-4)
    # Midpoint: 45 degrees.
    vh = v @ np.asarray(sp.uniforms(0.5).velocity_matrix)
    np.testing.assert_allclose(vh[:2], [10.0 / np.sqrt(2)] * 2,
                               atol=1e-3)


def test_rate_per_position_count_scale():
    """CountScale (ParticleSpawner.cs:166, 301-305): with RatePerPosition
    (the default) the configured rate is per emission stream — additional
    positions (+ polygon loop) multiply it; maximum_total scales the same
    way, and the spawn_max clamp re-credits its excess."""
    def build(**kw):
        args = dict(
            min_rate=120.0, max_rate=120.0,
            life=Formula1(constant=10.0),
            position=Formula3(constant=(0.0, 0.0, 0.0)),
            color=Formula4(constant=(1.0, 1.0, 1.0, 1.0)),
            spawn_max=64)
        args.update(kw)
        return Spawner(**args)

    base = build()
    scaled = build(additional_positions=[(10.0, 0.0, 0.0),
                                         (20.0, 0.0, 0.0)])
    assert base.begin_tick(0.0, 1.0 / 60.0) == 2
    assert scaled.begin_tick(0.0, 1.0 / 60.0) == 4  # 120*2*dt

    # spawn_max clamp re-credits the excess instead of dropping it.
    hot = build(max_rate=6000.0, min_rate=6000.0, spawn_max=64)
    c1 = hot.begin_tick(0.0, 1.0 / 60.0)
    assert c1 == 64 and hot.rate_error >= 35.0

    # maximum_total + granularity: the final sub-granularity remainder
    # retires instead of ping-ponging forever.
    fin = build(max_rate=600.0, min_rate=600.0, maximum_total=12)
    total = 0
    for _ in range(10):
        total += fin.begin_tick(0.0, 1.0 / 60.0, granularity=8)
    assert total == 8  # 12 rounds down to one granule; remainder retired
    assert fin.begin_tick(0.0, 1.0 / 60.0, granularity=8) == 0
    assert fin.rate_error == 0.0


def test_low_update_rate_does_not_stall():
    """updates_per_second below 1/maximum_update_delta must still tick
    (the accumulator clamp previously saturated below one step and the
    system froze forever)."""
    spn = Spawner(min_rate=15.0, max_rate=15.0,
                  life=Formula1(constant=10.0),
                  position=Formula3(constant=(10.0, 10.0, 0.0)),
                  color=Formula4(constant=(1.0, 1.0, 1.0, 1.0)))
    cfg = ParticleSystemConfig(capacity=256, updates_per_second=15.0,
                               life_decay_per_second=0.0)
    system = ParticleSystem(cfg, [spn])
    for _ in range(120):  # 2 simulated seconds at 60 fps
        system.update(1.0 / 60.0)
    assert system.live_count > 10  # ~30 spawned over 2 s at 15/s


def test_reset_reproduces_seeded_run():
    """reset() rewinds the tick index and re-seeds spawner streams, so
    the same system reproduces its run bit-for-bit."""
    spn = Spawner(min_rate=100.0, max_rate=300.0,  # stochastic rate
                  life=Formula1(constant=5.0),
                  position=Formula3(constant=(10.0, 10.0, 0.0),
                                    random_scale=(5.0, 5.0, 0.0)),
                  velocity=Formula3(random_scale=(10.0, 10.0, 0.0)),
                  color=Formula4(constant=(1.0, 1.0, 1.0, 1.0)))
    cfg = ParticleSystemConfig(capacity=1 << 10, updates_per_second=0.0,
                               life_decay_per_second=0.2)
    system = ParticleSystem(cfg, [spn], seed=11)
    for _ in range(20):
        system.tick(1.0 / 60.0)
    first = np.asarray(system.state.position).copy()
    system.reset()
    for _ in range(20):
        system.tick(1.0 / 60.0)
    np.testing.assert_array_equal(first,
                                  np.asarray(system.state.position))


def test_patch_reuses_jitted_step():
    """Live-patching with an unchanged structure must return the SAME
    jitted step object (per-frame animated-model patches would otherwise
    retrace the whole step every frame)."""
    spn = Spawner(min_rate=60.0, max_rate=60.0,
                  life=Formula1(constant=2.0),
                  position=Formula3(constant=(10.0, 10.0, 0.0)),
                  color=Formula4(constant=(1.0, 1.0, 1.0, 1.0)))
    grav = tx.Gravity(attractors=[tx.Attractor(
        position=(20.0, 20.0, 0.0), radius=100.0, strength=10.0,
        falloff_type=tx.FALLOFF_LINEAR)])
    cfg = ParticleSystemConfig(capacity=256, updates_per_second=0.0)
    system = ParticleSystem(cfg, [spn, grav])
    step0 = system._step
    grav2 = tx.Gravity(attractors=[tx.Attractor(
        position=(20.0, 20.0, 0.0), radius=100.0, strength=99.0,
        falloff_type=tx.FALLOFF_LINEAR)])
    system.patch(transforms=[spn, grav2])
    assert system._step is step0
