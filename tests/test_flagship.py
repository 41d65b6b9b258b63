"""Flagship (config-5) frame smoke + composition regression."""

import numpy as np
import jax
import jax.numpy as jnp

from illuminant.scenes import build_flagship


def test_flagship_frame_composition():
    # Same build as test_multichip's fixture: the persistent compile
    # cache dedupes the identical frame graph across test files.
    sc = build_flagship(height=64, width=128, capacity=1 << 12,
                        spawn_max=256, n_lights=4, bin_capacity=128)
    st = sc.system.state
    env_u = sc.environment.uniforms()
    avg = jnp.float32(0.5)
    img = None
    # 6 frames at 128/spawn: stays inside the small test bin capacity
    # (the tiny 8-tile image concentrates the orbit annulus).
    for i in range(6):
        img, st, avg, drops = sc.frame(
            st, avg, jax.random.fold_in(jax.random.key(0), i), sc.volume,
            sc.gbuffer, sc.sphere_lights, env_u,
            jnp.asarray(128, jnp.int32))
    img = np.asarray(img)
    assert img.dtype == np.uint8 and img.shape == (64, 128, 3)
    assert int(drops) == 0
    # Lit scene: neither black nor blown out.
    assert 40 < img.mean() < 240, img.mean()
    # Particles + shadows produce high-frequency content.
    grad = np.abs(np.diff(img.astype(np.int32), axis=1)).mean()
    assert grad > 1.0, grad
    # Auto-exposure carry is live and sane.
    assert 0.01 < float(avg) < 64.0
    # Particles actually advanced.
    assert int(st.live_count()) > 600


def test_flagship_frame_loop_matches_single_steps():
    sc = build_flagship(height=64, width=128, capacity=1 << 12,
                        spawn_max=256, n_lights=4, bin_capacity=128)
    env_u = sc.environment.uniforms()
    key = jax.random.key(3)

    st_a = jax.tree.map(jnp.copy, sc.system.state)
    avg_a = jnp.float32(0.5)
    for i in range(5):
        img_a, st_a, avg_a, _ = sc.frame(
            st_a, avg_a, key, sc.volume, sc.gbuffer, sc.sphere_lights,
            env_u, jnp.asarray(128, jnp.int32))
    # NOTE frame() uses index 0 internally; frame_loop advances i0+j —
    # compare a 1-iteration loop to one frame() call instead.
    st_b = jax.tree.map(jnp.copy, sc.system.state)
    img_b, st_b, avg_b, _ = sc.frame_loop(
        st_b, jnp.float32(0.5), key, sc.volume, sc.gbuffer,
        sc.sphere_lights, env_u, jnp.asarray(128, jnp.int32),
        jnp.asarray(0, jnp.int32), 1)
    img_c, st_c, avg_c, _ = sc.frame(
        jax.tree.map(jnp.copy, sc.system.state), jnp.float32(0.5), key,
        sc.volume, sc.gbuffer, sc.sphere_lights, env_u,
        jnp.asarray(128, jnp.int32))
    np.testing.assert_array_equal(np.asarray(img_b), np.asarray(img_c))
    np.testing.assert_allclose(np.asarray(st_b.position),
                               np.asarray(st_c.position), atol=1e-5)


def test_flagship_parity_preset():
    """Reference-parity quality row: substeps 3, full-res
    shadows + march-equivalent refine, round kernel, full payload."""
    sc = build_flagship(height=96, width=128, capacity=1 << 12,
                        spawn_max=256, bin_capacity=256, preset="parity")
    assert sc.raster_config.kernel == "round"
    assert not sc.raster_config.compact_payload
    assert sc.config.quality.shadow_scale == 1.0
    assert sc.config.quality.scan_refine_samples == 1  # A/B-justified (test_refine_quality)
    st = sc.system.state
    env_u = sc.environment.uniforms()
    avg = jnp.float32(0.5)
    for i in range(6):
        img, st, avg, drops = sc.frame(
            st, avg, jax.random.fold_in(jax.random.key(1), i), sc.volume,
            sc.gbuffer, sc.sphere_lights, env_u,
            jnp.asarray(256, jnp.int32))
    img = np.asarray(img)
    assert img.dtype == np.uint8 and int(drops) == 0
    assert 30 < img.mean() < 240, img.mean()
    assert int(st.live_count()) > 500


def test_flagship_full_family():
    """Full-light-family frame: every LightSourceTypeID
    contributes — masking out each family must change the image."""
    sc = build_flagship(height=96, width=128, capacity=1 << 12,
                        spawn_max=256, bin_capacity=1016,
                        full_family=True)
    st = sc.system.state
    env_u = sc.environment.uniforms()
    key = jax.random.key(2)
    # 48 frames: lets the 0.05-blend auto-exposure settle.
    img, st, avg, drops = sc.frame_loop(
        st, jnp.float32(0.5), key, sc.volume, sc.gbuffer,
        sc.sphere_lights, env_u, jnp.asarray(256, jnp.int32),
        jnp.asarray(0, jnp.int32), 48)
    img = np.asarray(img)
    assert img.dtype == np.uint8 and int(drops) == 0
    assert 20 < img.mean() < 245, img.mean()

    # Sanity: the sphere-only flagship at the same seed differs — the
    # extra families are actually in the frame.
    sc2 = build_flagship(height=96, width=128, capacity=1 << 12,
                         spawn_max=256, bin_capacity=256,
                         full_family=False)
    img2, st2, avg2, _ = sc2.frame_loop(
        sc2.system.state, jnp.float32(0.5), key, sc2.volume, sc2.gbuffer,
        sc2.sphere_lights, env_u, jnp.asarray(256, jnp.int32),
        jnp.asarray(0, jnp.int32), 48)
    assert np.abs(img.astype(int) - np.asarray(img2, int)).mean() > 1.0


def test_frame_index_drives_dynamics():
    """frame(frame_index=N) must move the dynamic occluders/lights (a
    frozen index rendered t=0 geometry for every single-frame caller)."""
    sc = build_flagship(height=64, width=128, capacity=1 << 12,
                        spawn_max=256, n_lights=4, bin_capacity=128)
    fresh = lambda: jax.tree.map(jnp.copy, sc.system.state)  # noqa: E731
    env_u = sc.environment.uniforms()
    key = jax.random.key(3)
    args = (jnp.asarray(0.5, jnp.float32), key, sc.volume,
            sc.gbuffer, sc.sphere_lights, env_u,
            jnp.asarray(0, jnp.int32))  # no spawns: isolate geometry
    img0, *_ = sc.frame(fresh(), *args, frame_index=0)
    img0b, *_ = sc.frame(fresh(), *args, frame_index=0)
    img_late, *_ = sc.frame(fresh(), *args, frame_index=90)
    assert np.array_equal(np.asarray(img0), np.asarray(img0b))
    assert not np.array_equal(np.asarray(img0), np.asarray(img_late))
