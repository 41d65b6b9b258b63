"""Multi-device sharding: the sharded frame equals the unsharded frame.

SURVEY.md §4: multi-device tests run on the virtual 8-CPU mesh
(conftest.py sets xla_force_host_platform_device_count=8). The full
flagship frame step is jitted over a jax.sharding.Mesh with the pixel
grid row-sharded and the particle capacity sharded; outputs must match
the single-device run exactly (the math is identical — only layout and
collectives differ).

Sharded runs use a MESH-BUILT scene (build_flagship(mesh=...)): the scan
passes pin their sequential nomination walks replicated and the
per-pixel readout row-sharded (scan_shadows.spmd_mesh), which removes
the in-loop collective-permute storm that deadlocked XLA:CPU's
rendezvous in round 3. The unsharded comparison runs a
mesh-free build of the same scene.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from illuminant.parallel import mesh as pmesh

SCENE_KW = dict(height=64, width=128, capacity=1 << 12, spawn_max=256,
                bin_capacity=128)


def _build(n_lights=4, mesh=None, **kw):
    from illuminant.scenes import build_flagship

    return build_flagship(n_lights=n_lights, mesh=mesh, **SCENE_KW, **kw)


@pytest.fixture(scope="module")
def scene():
    return _build()


@pytest.fixture(scope="module")
def scene_m():
    return _build(mesh=pmesh.make_mesh(8))


def _run(scene, state, sharded: bool, n_frames: int = 3):
    env_u = scene.environment.uniforms()
    key = jax.random.key(7)
    avg = jnp.asarray(0.5, jnp.float32)
    volume, gbuffer, lights = scene.volume, scene.gbuffer, \
        scene.sphere_lights
    spawn_count = jnp.asarray(128, jnp.int32)

    if sharded:
        mesh = pmesh.make_mesh(8)
        gbuffer = pmesh.shard_gbuffer(gbuffer, mesh)
        state = pmesh.shard_particles(state, mesh)
        volume = pmesh.replicate(volume, mesh)
        lights = pmesh.replicate(lights, mesh)
        env_u = pmesh.replicate(env_u, mesh)
        key = jax.device_put(key, pmesh.replicated(mesh))
        avg = jax.device_put(avg, pmesh.replicated(mesh))
        spawn_count = jax.device_put(spawn_count, pmesh.replicated(mesh))

    imgs = []
    for i in range(n_frames):
        img, state, avg, drops = scene.frame(
            state, avg, jax.random.fold_in(key, i), volume, gbuffer,
            lights, env_u, spawn_count,
        )
        imgs.append(np.asarray(img))
    return imgs, state, float(avg)


def _compare(scene_plain, scene_mesh, n_frames=3):
    # frame() donates the state buffers — give each run its own copy.
    fresh = lambda s: jax.tree.map(jnp.copy, s.system.state)  # noqa: E731
    imgs_a, state_a, avg_a = _run(scene_plain, fresh(scene_plain),
                                  sharded=False, n_frames=n_frames)
    imgs_b, state_b, avg_b = _run(scene_mesh, fresh(scene_mesh),
                                  sharded=True, n_frames=n_frames)
    for a, b in zip(imgs_a, imgs_b):
        # uint8 output: allow off-by-one from reassociated float sums.
        diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
        assert diff.max() <= 1, diff.max()
    np.testing.assert_allclose(
        np.asarray(state_a.position), np.asarray(state_b.position),
        rtol=1e-5, atol=1e-4,
    )
    assert abs(avg_a - avg_b) < 1e-4


def test_eight_device_mesh_available():
    assert jax.device_count() >= 8


def test_sharded_frame_matches_unsharded(scene, scene_m):
    _compare(scene, scene_m)


def test_sharded_output_is_distributed(scene_m):
    mesh = pmesh.make_mesh(8)
    env_u = pmesh.replicate(scene_m.environment.uniforms(), mesh)
    gbuffer = pmesh.shard_gbuffer(scene_m.gbuffer, mesh)
    state = pmesh.shard_particles(
        jax.tree.map(jnp.copy, scene_m.system.state), mesh)
    volume = pmesh.replicate(scene_m.volume, mesh)
    lights = pmesh.replicate(scene_m.sphere_lights, mesh)
    img, state2, avg, drops = scene_m.frame(
        state, jax.device_put(jnp.float32(0.5), pmesh.replicated(mesh)),
        jax.device_put(jax.random.key(0), pmesh.replicated(mesh)),
        volume, gbuffer, lights, env_u,
        jax.device_put(jnp.asarray(128, jnp.int32),
                       pmesh.replicated(mesh)),
    )
    img.block_until_ready()
    assert len(img.sharding.device_set) == 8, img.sharding
    assert len(state2.position.sharding.device_set) == 8


def test_spawn_sub_rings_unit():
    """sub_rings spawn: each capacity segment receives count/D rows at a
    shared local cursor; liveness and totals match the global ring up to
    the multiple-of-D rounding."""
    from illuminant.particles.spawner import Spawner, spawn
    from illuminant.particles.state import ParticleState
    from illuminant.particles.formula import Formula1, Formula3

    sp = Spawner(min_rate=0, max_rate=0,
                 life=Formula1(constant=5.0),
                 position=Formula3(constant=(1.0, 2.0, 3.0)))
    u = sp.uniforms(0.0)
    key = jax.random.key(0)
    D = 8
    cap, smax = 256, 64
    st = ParticleState.empty(cap)
    st = spawn(st, u, jnp.asarray(40), key, smax, sub_rings=D)
    live = np.asarray(st.position[:, 3] > 0)
    # 40 rounds to 40: spawned, 5 per segment at local cursor 0.
    assert live.sum() == 40
    per_seg = live.reshape(D, cap // D).sum(axis=1)
    np.testing.assert_array_equal(per_seg, np.full(D, 5))
    # Second spawn lands at the advanced local cursor, no overwrite.
    st = spawn(st, u, jnp.asarray(24), jax.random.fold_in(key, 1), smax,
               sub_rings=D)
    live = np.asarray(st.position[:, 3] > 0)
    assert live.sum() == 64
    per_seg = live.reshape(D, cap // D).sum(axis=1)
    np.testing.assert_array_equal(per_seg, np.full(D, 8))
    # Count rounds DOWN to a multiple of D.
    st2 = spawn(ParticleState.empty(cap), u, jnp.asarray(13), key, smax,
                sub_rings=D)
    assert int(np.asarray(st2.position[:, 3] > 0).sum()) == 8


def test_sub_ring_sharded_matches_unsharded():
    """The sub-ring flagship frame is numerically identical sharded vs
    unsharded, AND its spawn write stays shard-local (the roll is along
    the intra-segment axis)."""
    _compare(_build(spawn_sub_rings=8),
             _build(spawn_sub_rings=8, mesh=pmesh.make_mesh(8)))


def test_full_family_sharded_matches_unsharded():
    """The FULL light-family frame (directional sun + line + windowed
    shadowed volumetric + windowed projector + particle lights riding
    the fused multi-family scan) must shard transparently too — the
    windowed lights and the fused scan are the paths the sphere-only
    flagship test never exercises. This is the configuration whose
    collective-permute rendezvous deadlocked (SIGABRT) in round 3."""
    _compare(_build(n_lights=2, full_family=True),
             _build(n_lights=2, full_family=True,
                    mesh=pmesh.make_mesh(8)),
             n_frames=2)
