"""SDF primitive formulas vs numpy oracles / analytic distances."""

import numpy as np

from illuminant.ops import sdf_primitives as sp


def rand_points(n, scale=50.0, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-scale, scale, size=(n, 3)).astype(np.float32)


IDENTITY_Q = np.asarray([0.0, 0.0, 0.0, 1.0], np.float32)


def test_box_oracle():
    p = rand_points(256)
    size = np.asarray([10.0, 5.0, 2.0], np.float32)
    got = np.asarray(sp.sd_box(p, size))
    d = np.abs(p) - size
    want = np.minimum(np.max(d, axis=-1), 0.0) + np.linalg.norm(
        np.maximum(d, 0.0), axis=-1
    )
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_sphere_is_exact():
    # Equal-radius ellipsoid == sphere: |p| - r everywhere.
    p = rand_points(256, seed=1)
    r = np.asarray([7.0, 7.0, 7.0], np.float32)
    got = np.asarray(sp.sd_ellipsoid(p, r))
    want = np.linalg.norm(p, axis=-1) - 7.0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_spheroid_equal_sizes_is_sphere():
    p = rand_points(256, seed=2)
    r = np.asarray([4.0, 4.0, 4.0], np.float32)
    got = np.asarray(sp.sd_spheroid(p, r))
    want = np.linalg.norm(p, axis=-1) - 4.0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_cylinder_axis_points():
    size = np.asarray([3.0, 4.0, 10.0], np.float32)  # radius length(3,4)=5
    # On the z axis inside: distance is to the nearest cap or wall.
    p = np.asarray([[0, 0, 0], [0, 0, 12], [9, 0, 0]], np.float32)
    got = np.asarray(sp.sd_cylinder(p, size))
    np.testing.assert_allclose(got[0], -5.0, atol=1e-5)  # wall is closest
    np.testing.assert_allclose(got[1], 2.0, atol=1e-5)  # above top cap
    np.testing.assert_allclose(got[2], 4.0, atol=1e-5)  # outside wall


def test_quaternion_rotation_matches_qmul_oracle():
    rng = np.random.default_rng(3)
    for _ in range(10):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        ang = rng.uniform(0, 2 * np.pi)
        q = np.concatenate(
            [axis * np.sin(ang / 2), [np.cos(ang / 2)]]
        ).astype(np.float32)
        p = rng.normal(size=(5, 3)).astype(np.float32)

        # Oracle: q * (p,0) * conj(q) via explicit quaternion products
        # (DistanceFunctionCommon.fxh:15-26).
        def qmul(a, b):
            av, aw = a[:3], a[3]
            bv, bw = b[:3], b[3]
            return np.concatenate(
                [bv * aw + av * bw + np.cross(av, bv), [aw * bw - av @ bv]]
            )

        want = np.stack(
            [
                qmul(q, qmul(np.concatenate([pi, [0.0]]), q * [-1, -1, -1, 1]))[:3]
                for pi in p
            ]
        )
        got = np.asarray(sp.rotate_by_quaternion(p, q))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_rotated_box():
    # Box rotated 90 degrees about z: effective extents swap in x/y.
    q = np.asarray(
        [0.0, 0.0, np.sin(np.pi / 4), np.cos(np.pi / 4)], np.float32
    )
    p = np.asarray([[8.0, 0.0, 0.0]], np.float32)
    d_rot = np.asarray(
        sp.evaluate_by_type(
            np.asarray([sp.TYPE_BOX]),
            p,
            np.zeros((1, 3), np.float32),
            np.asarray([[2.0, 6.0, 6.0]], np.float32),
            q[None],
        )
    )
    # Rotating the query by q maps x->±y, so the 6-extent faces x: d = 8-6.
    np.testing.assert_allclose(d_rot[0], 2.0, atol=1e-4)


def test_none_type_is_identity_under_min():
    p = rand_points(16, seed=4)
    types = np.asarray([sp.TYPE_NONE, sp.TYPE_BOX], np.int32)
    centers = np.zeros((2, 3), np.float32)
    sizes = np.ones((2, 3), np.float32) * 3.0
    rots = np.tile(IDENTITY_Q, (2, 1))
    d = np.asarray(sp.scene_distance(p, types, centers, sizes, rots))
    d_box_only = np.asarray(sp.sd_box(p, sizes[1]))
    np.testing.assert_allclose(d, d_box_only, rtol=1e-5, atol=1e-5)


def test_octagon_center_inside():
    size = np.asarray([5.0, 5.0, 3.0], np.float32)
    p = np.asarray([[0.0, 0.0, 0.0], [0.0, 0.0, 10.0]], np.float32)
    d = np.asarray(sp.sd_octagon(p, size))
    assert d[0] < 0  # center is inside
    np.testing.assert_allclose(d[1], 7.0, atol=1e-4)  # above the prism cap


def test_degenerate_ellipsoid_no_nans():
    """Flat (zero-extent) ellipsoids must not NaN-poison any eval path:
    pack-time clamping + normal clamps (review findings — the vectorized
    path and closed-form normals divided by r^2 unclamped)."""
    import numpy as np
    import jax.numpy as jnp
    from illuminant.lighting.environment import LightObstruction
    from illuminant.sdf.analytic import (
        pack_scene, scene_normal_p, scene_sample_p)

    obs = [LightObstruction.ellipsoid((10.0 * i, 5.0, 4.0), (4.0, 4.0, 0.0))
           for i in range(80)]  # > _UNROLL_LIMIT -> vectorized path
    scene = pack_scene(obs, group_capacity_round=1)
    xs = jnp.linspace(-5.0, 800.0, 257)
    d = np.asarray(scene_sample_p(scene, xs, 5.0, 2.0))
    assert np.isfinite(d).all()
    nx, ny, nz = scene_normal_p(scene, xs, 5.0, 2.0, fast=True)
    assert np.isfinite(np.asarray(nx)).all()
    assert np.isfinite(np.asarray(ny)).all()
    assert np.isfinite(np.asarray(nz)).all()
    # Small scene (unrolled path + closed-form normals) too.
    small = pack_scene(obs[:3], group_capacity_round=1)
    nx, ny, nz = scene_normal_p(small, xs, 5.0, 2.0, fast=True)
    assert np.isfinite(np.asarray(nx)).all()


def test_scene_queries_handle_none_field():
    import numpy as np
    import jax.numpy as jnp
    from illuminant.sdf.analytic import scene_normal_p, scene_sample_p

    d = scene_sample_p(None, jnp.zeros(4), jnp.zeros(4), jnp.zeros(4))
    assert np.isfinite(np.asarray(d)).all()
    nx, ny, nz = scene_normal_p(None, jnp.zeros(4), jnp.zeros(4),
                                jnp.zeros(4))
    assert np.allclose(np.asarray(nz), 1.0)


def test_pack_scene_rejects_unknown_type():
    import pytest
    import dataclasses
    from illuminant.lighting.environment import LightObstruction
    from illuminant.sdf.analytic import pack_scene

    bad = LightObstruction.box((0.0, 0.0, 0.0), (1.0, 1.0, 1.0))
    bad.type = 42
    with pytest.raises(ValueError, match="unknown obstruction type"):
        pack_scene([bad])
