"""Misc kernel parity: BezierM/DynamicMatrix, ProcessHeightmap family,
HDRBitmap."""

import numpy as np
import jax.numpy as jnp

from illuminant.core.config import HDR_MODE_TONEMAP, HDRConfig
from illuminant.ops.bezier import (
    DynamicMatrix,
    evaluate_bezier_matrix,
    pack_bezier_matrix,
)
from illuminant.raster.resolve import hdr_bitmap
from illuminant.utils.mapgen import (
    height_from_distance,
    heightmap_to_displacement,
    heightmap_to_normals,
)


def test_dynamic_matrix_regenerate_rotation():
    m = DynamicMatrix.from_components(angle=90.0, scale=2.0,
                                      translation=(3.0, 4.0, 5.0))
    mat = np.asarray(m.regenerate())
    # Row-vector convention: (1, 0, 0, 1) @ mat = (cos, sin)*2 + t.
    v = np.asarray([1.0, 0.0, 0.0, 1.0]) @ mat
    np.testing.assert_allclose(v[:3], [3.0, 6.0, 5.0], atol=1e-5)


def test_bezier_m_fully_dynamic_interpolates_angle_scale():
    a = DynamicMatrix.from_components(angle=0.0, scale=1.0)
    b = DynamicMatrix.from_components(angle=90.0, scale=3.0)
    bm = pack_bezier_matrix([a, b])
    mid = np.asarray(evaluate_bezier_matrix(bm, 0.5))
    # Midpoint: angle 45, scale 2 (angle/scale interpolation, NOT matrix
    # element lerp — the whole point of the dynamic path).
    expect = np.asarray(
        DynamicMatrix.from_components(angle=45.0, scale=2.0).regenerate()
    )
    np.testing.assert_allclose(mid, expect, atol=1e-5)
    # Matrix-element lerp would differ: cos(45)*2 != lerp(cos0*1, cos90*3).
    lerped = 0.5 * np.asarray(a.regenerate()) + 0.5 * np.asarray(
        b.regenerate())
    assert abs(mid[0, 0] - lerped[0, 0]) > 0.2


def test_bezier_m_matrix_path_lerps_rows():
    a = DynamicMatrix.from_matrix(np.eye(4, dtype=np.float32))
    mb = np.eye(4, dtype=np.float32)
    mb[3, 0] = 10.0
    b = DynamicMatrix.from_matrix(mb)
    bm = pack_bezier_matrix([a, b])
    mid = np.asarray(evaluate_bezier_matrix(bm, 0.5))
    assert abs(mid[3, 0] - 5.0) < 1e-5


def test_heightmap_to_normals_slope():
    h = np.tile(np.linspace(0.0, 1.0, 32, dtype=np.float32), (16, 1))
    n = np.asarray(heightmap_to_normals(jnp.asarray(h)))
    decoded = n[8, 16, :3] * 2.0 - 1.0
    # Height increases with +x -> normal tilts toward -x.
    assert decoded[0] < -0.05
    assert abs(decoded[1]) < 1e-3
    assert decoded[2] > 0.5
    assert n[8, 16, 3] > 0.5  # alpha on for non-flat


def test_heightmap_flat_region_alpha_zero():
    h = np.zeros((8, 8), np.float32)
    n = np.asarray(heightmap_to_normals(jnp.asarray(h)))
    assert n[..., 3].max() == 0.0


def test_heightmap_elevation_clamping_kills_uphill_influence():
    h = np.zeros((8, 16), np.float32)
    h[:, 8:] = 1.0  # a cliff
    plain = np.asarray(heightmap_to_normals(jnp.asarray(h)))
    clamped = np.asarray(
        heightmap_to_normals(jnp.asarray(h), normal_elevation_clamping=True)
    )
    # Just downhill of the cliff (x=7): clamping removes the uphill tap.
    assert abs(plain[4, 7, 0] * 2 - 1) > 0.3
    assert abs(clamped[4, 7, 0] * 2 - 1) < 1e-3


def test_heightmap_to_displacement_range():
    h = np.tile(np.linspace(0.0, 1.0, 32, dtype=np.float32), (16, 1))
    d = np.asarray(heightmap_to_displacement(jnp.asarray(h), (2.0, 2.0)))
    assert d[..., 2].max() == 0.5 and d[..., 3].min() == 1.0
    assert d[8, 16, 0] < 0.5  # slope displaces -x


def test_height_from_distance_ramp_and_discard():
    dist = jnp.asarray([[0.0, 8.0, 16.0, 40.0]], jnp.float32)
    out = np.asarray(
        height_from_distance(dist, min_distance=0.0, max_distance=32.0,
                             min_height=0.0, max_height=1.0)
    )
    assert out[0, 0, 0] == 1.0  # at the surface: max height
    assert out[0, 0, 0] > out[0, 1, 0] > out[0, 2, 0]
    assert out[0, 3, 0] == 0.0 and out[0, 3, 3] == 0.0  # discard


def test_hdr_bitmap_tonemap_matches_resolve_operator():
    from illuminant.ops import tonemap as tm

    tex = jnp.asarray(np.random.default_rng(0).uniform(
        0.0, 4.0, (8, 8, 4)).astype(np.float32))
    hdr = HDRConfig(mode=HDR_MODE_TONEMAP, exposure=1.5, white_point=4.0)
    out = np.asarray(hdr_bitmap(tex, hdr))
    pre = np.maximum(np.asarray(tex)[..., :3], 0.0) * 1.5
    expect = np.asarray(tm.uncharted2_tonemap(jnp.asarray(pre))) / float(
        tm.uncharted2_tonemap(jnp.float32(4.0)))
    np.testing.assert_allclose(out[..., :3], expect, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out[..., 3], np.asarray(tex)[..., 3])


def test_hdr_bitmap_add_color_premultiplies():
    tex = jnp.ones((2, 2, 4), jnp.float32)
    out_with = np.asarray(
        hdr_bitmap(tex, HDRConfig(mode=HDR_MODE_TONEMAP),
                   add_color=(1.0, 0.0, 0.0, 0.5))
    )
    out_without = np.asarray(hdr_bitmap(tex, HDRConfig(mode=HDR_MODE_TONEMAP)))
    assert out_with[0, 0, 0] > out_without[0, 0, 0]
    assert out_with[0, 0, 2] == out_without[0, 0, 2]
