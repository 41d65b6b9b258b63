"""Light probes, particle lights, vector field force."""

import numpy as np

from illuminant.core.config import QualitySettings, RendererConfig
from illuminant.lighting.environment import (
    LightObstruction,
    LightingEnvironment,
    SphereLightSource,
    pack_sphere_lights,
)
from illuminant.lighting.gbuffer import flat_ground
from illuminant.lighting.particle_light import (
    ParticleLightSource,
    accumulate_particle_lights_jit,
)
from illuminant.lighting.probes import (
    LightProbe,
    evaluate_probes_jit,
    pack_probes,
)
from illuminant.sdf.analytic import pack_scene
from illuminant.particles.formula import Formula1, Formula3, Formula4
from illuminant.particles.spawner import Spawner
from illuminant.particles.system import ParticleSystem, ParticleSystemConfig
from illuminant.particles import transforms as tx


def test_probes_match_falloff_and_shadow():
    scene = pack_scene(
        [LightObstruction.box((128.0, 128.0, 16.0), (10.0, 40.0, 16.0))]
    )
    lights = pack_sphere_lights(
        [SphereLightSource(position=(60.0, 128.0, 32.0), radius=8.0,
                           ramp_length=200.0, color=(1.0, 1.0, 1.0, 1.0))]
    )
    probes = pack_probes(
        [
            LightProbe(position=(70.0, 128.0, 1.0)),  # near light
            LightProbe(position=(200.0, 128.0, 1.0)),  # behind the box
            LightProbe(position=(60.0, 30.0, 1.0)),  # open, farther
        ]
    )
    env = LightingEnvironment().uniforms()
    values = np.asarray(
        evaluate_probes_jit(scene, probes, env, QualitySettings(),
                        sphere_lights=lights)
    )
    assert values.shape == (3, 4)
    assert values[0, 0] > 0.5, values[0]
    assert values[1, 0] < 0.05, values[1]  # shadowed
    assert 0.0 < values[2, 0] < values[0, 0]


def test_probe_normal_masks_backfacing_light():
    lights = pack_sphere_lights(
        [SphereLightSource(position=(0.0, 0.0, 10.0), radius=4.0,
                           ramp_length=100.0)]
    )
    probes = pack_probes(
        [
            LightProbe(position=(20.0, 0.0, 0.0), normal=(0, 0, 1)),
            LightProbe(position=(20.0, 0.0, 0.0), normal=(0, 0, -1)),
            LightProbe(position=(20.0, 0.0, 0.0)),  # no normal
        ]
    )
    env = LightingEnvironment().uniforms()
    v = np.asarray(
        evaluate_probes_jit(None, probes, env, QualitySettings(),
                        sphere_lights=lights)
    )
    assert v[0, 0] > 0.3
    assert v[1, 0] < 0.05  # facing away
    assert v[2, 0] >= v[0, 0]  # normal-less probes skip the dot mask


def _particle_system_at(points):
    cfg = ParticleSystemConfig(capacity=64, updates_per_second=0.0,
                               life_decay_per_second=0.0)
    system = ParticleSystem(cfg, [])
    import jax.numpy as jnp

    st = system.state
    pos = np.zeros((64, 4), np.float32)
    col = np.zeros((64, 4), np.float32)
    for i, p in enumerate(points):
        pos[i] = [*p, 10.0]
        col[i] = [1.0, 0.8, 0.2, 1.0]
    system.state = st.replace(position=jnp.asarray(pos),
                              color=jnp.asarray(col))
    return system


def test_particle_lights_illuminate():
    system = _particle_system_at([(64.0, 64.0, 20.0)])
    env = LightingEnvironment()
    gb = flat_ground(128, 128, env.uniforms())
    src = ParticleLightSource(
        template=SphereLightSource(radius=6.0, ramp_length=60.0,
                                   cast_shadows=False),
        max_lights=64,
    )
    out = np.asarray(
        accumulate_particle_lights_jit(
            None, gb, system.state, src, env.uniforms(),
            QualitySettings(), shadow_mode="march",
        )
    )
    under = out[64, 64, :3].mean()
    far = out[10, 120, :3].mean()
    assert under > 0.2, under
    assert far < under * 0.1


def test_vector_field_force():
    field = np.zeros((16, 16, 4), np.float32)
    field[:, :, 0] = 1.0  # uniform +x force
    cfg = ParticleSystemConfig(capacity=128, updates_per_second=0.0,
                               life_decay_per_second=0.0)
    spn = Spawner(
        min_rate=600.0, max_rate=600.0,
        life=Formula1(constant=100.0),
        position=Formula3(constant=(8.0, 8.0, 0.0)),
        velocity=Formula3(constant=(0.0, 0.0, 0.0)),
        spawn_max=32,
    )
    vf = tx.VectorField(field=field, velocity_scale=(30.0, 30.0, 0.0, 0.0),
                        field_scale=(1.0, 1.0), cycles_per_second=1.0)
    system = ParticleSystem(cfg, [spn, vf])
    for _ in range(30):
        system.tick(1.0 / 60.0)
    live = np.asarray(system.state.live_mask())
    vel = np.asarray(system.state.velocity)[live]
    assert vel[:, 0].mean() > 0.05, "field should push +x"
    assert abs(vel[:, 1].mean()) < 1e-3
