"""SDF volume generation, trilinear sampling, incremental updates, IO."""

import numpy as np

from illuminant.ops import sdf_primitives as sp
from illuminant.sdf import sampling, volume as vol


def sphere_volume(radius=20.0, center=(64.0, 64.0, 32.0), scale=0.5):
    config = vol.SdfVolumeConfig(
        virtual_width=128,
        virtual_height=128,
        virtual_depth=64,
        slice_count=32,
        resolution_scale=scale,
        max_encoded_distance=128.0,
    )
    obs = vol.SdfObstructions.from_lists(
        types=[sp.TYPE_ELLIPSOID],
        centers=[center],
        sizes=[[radius] * 3],
    )
    return vol.generate_volume(config, obs), config


def test_sample_matches_analytic_inside_volume():
    v, config = sphere_volume()
    rng = np.random.default_rng(0)
    pts = rng.uniform([8, 8, 4], [120, 120, 56], size=(512, 3)).astype(
        np.float32
    )
    got = np.asarray(sampling.sample(v, pts))
    want = np.linalg.norm(pts - np.asarray([64, 64, 32.0]), axis=-1) - 20.0
    # Tolerance: one voxel (2 world units at scale 0.5 / slice z size 2).
    np.testing.assert_allclose(got, want, atol=2.5)


def test_out_of_volume_correction():
    v, config = sphere_volume()
    # Far outside the volume: the AABB-distance term dominates and grows
    # linearly (fxh:320-352), so queries stay conservative.
    p_near = np.asarray([[140.0, 64.0, 32.0]], np.float32)
    p_far = np.asarray([[240.0, 64.0, 32.0]], np.float32)
    d_near = float(sampling.sample(v, p_near)[0])
    d_far = float(sampling.sample(v, p_far)[0])
    assert d_far > d_near
    np.testing.assert_allclose(d_far - d_near, 100.0, atol=1.0)


def test_incremental_slice_update():
    v, config = sphere_volume()
    empty = vol.SdfVolume.empty(config)
    obs = vol.SdfObstructions.from_lists(
        types=[sp.TYPE_ELLIPSOID],
        centers=[[64.0, 64.0, 32.0]],
        sizes=[[20.0] * 3],
    )
    # Regenerate 4 slices at a time (budgeted incremental updates).
    cur = empty
    for start in range(0, config.slice_count, 4):
        slab = vol.generate_slab(config, obs, start, 4)
        cur = vol.update_slices(cur, start, slab)
    cur = cur.replace(max_valid_z=v.max_valid_z)
    np.testing.assert_allclose(
        np.asarray(cur.data), np.asarray(v.data), atol=1e-6
    )


def test_static_dynamic_combine():
    config = vol.SdfVolumeConfig(
        virtual_width=64, virtual_height=64, virtual_depth=32, slice_count=8
    )
    s = vol.generate_volume(
        config,
        vol.SdfObstructions.from_lists(
            [sp.TYPE_BOX], [[16.0, 32.0, 16.0]], [[8.0, 8.0, 8.0]]
        ),
    )
    d = vol.generate_volume(
        config,
        vol.SdfObstructions.from_lists(
            [sp.TYPE_BOX], [[48.0, 32.0, 16.0]], [[8.0, 8.0, 8.0]]
        ),
    )
    combined = vol.combine_static_dynamic(s, d)
    assert np.all(
        np.asarray(combined.data)
        <= np.minimum(np.asarray(s.data), np.asarray(d.data)) + 1e-6
    )


def test_estimate_normal_radial():
    v, config = sphere_volume()
    pts = np.asarray(
        [[64.0 + 25.0, 64.0, 32.0], [64.0, 64.0 - 25.0, 32.0]], np.float32
    )
    n = np.asarray(sampling.estimate_normal(v, pts))
    np.testing.assert_allclose(n[0], [1.0, 0.0, 0.0], atol=0.15)
    np.testing.assert_allclose(n[1], [0.0, -1.0, 0.0], atol=0.15)


def test_encode_decode_roundtrip():
    d = np.linspace(-128, 128, 64).astype(np.float32)
    e = vol.encode_distance(d, 128.0)
    back = np.asarray(vol.decode_distance(e, 128.0))
    np.testing.assert_allclose(back, d, atol=1e-4)


def test_save_load_roundtrip(tmp_path):
    v, config = sphere_volume()
    path = str(tmp_path / "field.npz")
    vol.save(v, path)
    v2 = vol.load(path)
    assert v2.config == config
    np.testing.assert_allclose(np.asarray(v2.data), np.asarray(v.data))
    np.testing.assert_allclose(
        float(v2.max_valid_z), float(v.max_valid_z)
    )
