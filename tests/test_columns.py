"""Column-interval decomposition (sdf/columns.py) bounds.

The approximation contract from the module docstring, pinned:
  * z-PRISM content (vertical boxes/cylinders): the reconstruction is
    exact to xy-bilinear of the maps + bf16.
  * Narrowing shapes (ellipsoids): conservative (d-underestimate) —
    sphere tracing stays correct.
  * The coarse (2x) scattered pack tracks the full-res maps within a
    box-filter bound.
  * The gradient matches finite differences of the reconstruction.
  * reconstruct_profile == sample semantics for carried-scan inputs.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from illuminant.lighting.environment import (
    LightingEnvironment,
    LightObstruction,
)
from illuminant.sdf import volume as vol
from illuminant.sdf.columns import (
    ColumnField,
    build_column_maps,
    reconstruct_profile,
    resample_map_to_grid,
    sample_columns,
    sample_columns_grad,
)
from illuminant.sdf.sampling import sample


def _prism_env():
    env = LightingEnvironment(maximum_z=64.0)
    env.obstructions.append(LightObstruction.box(
        (60.0, 40.0, 16.0), (18.0, 12.0, 16.0)))
    env.obstructions.append(LightObstruction.cylinder(
        (130.0, 70.0, 20.0), (10.0, 10.0, 20.0)))
    return env


def _field(env, width=192, height=96, scale=0.5):
    cfg = vol.SdfVolumeConfig(
        virtual_width=width, virtual_height=height, virtual_depth=64.0,
        resolution_scale=scale, slice_count=16)
    return vol.generate_volume(cfg, env.pack_obstructions()), cfg


def _query_points(key, width, height, n=4096):
    ks = jax.random.split(key, 3)
    x = jax.random.uniform(ks[0], (n,), minval=-10.0, maxval=width + 10.0)
    y = jax.random.uniform(ks[1], (n,), minval=-10.0, maxval=height + 10.0)
    z = jax.random.uniform(ks[2], (n,), minval=-5.0, maxval=70.0)
    return jnp.stack([x, y, z], axis=-1)


def test_prism_reconstruction_close_to_exact():
    volume, _ = _field(_prism_env())
    cf = build_column_maps(volume, coarse=1)
    pos = _query_points(jax.random.key(1), 192, 96)
    d_cols = np.asarray(sample_columns(cf, pos))
    d_ref = np.asarray(sample(volume, pos))
    err = np.abs(d_cols - d_ref)
    # z-prisms: exact up to xy-bilinear of the maps + bf16 pack +
    # the z-lerp's own shape (the stored profile is slice-lerped, the
    # reconstruction is continuous) — sub-voxel in practice.
    assert err.mean() < 0.2, err.mean()
    assert np.percentile(err, 99) < 1.5, np.percentile(err, 99)


def test_coarse_pack_tracks_full():
    volume, _ = _field(_prism_env())
    cf_f = build_column_maps(volume, coarse=1)
    cf_c = build_column_maps(volume, coarse=2)
    assert cf_c.maps_c.shape[1] * 2 == cf_f.maps_c.shape[1]
    pos = _query_points(jax.random.key(2), 192, 96)
    d_f = np.asarray(sample_columns(cf_f, pos))
    d_c = np.asarray(sample_columns(cf_c, pos))
    err = np.abs(d_f - d_c)
    # 2x box filter of 1-Lipschitz maps: error bounded by ~a coarse
    # cell near kinks, tiny elsewhere.
    assert err.mean() < 0.5, err.mean()
    assert np.percentile(err, 99) < 3.0, np.percentile(err, 99)


def test_conservative_on_ellipsoid():
    env = LightingEnvironment(maximum_z=64.0)
    env.obstructions.append(LightObstruction.ellipsoid(
        (96.0, 48.0, 24.0), (24.0, 16.0, 20.0)))
    volume, _ = _field(env)
    cf = build_column_maps(volume, coarse=1)
    pos = _query_points(jax.random.key(3), 192, 96)
    d_cols = np.asarray(sample_columns(cf, pos))
    d_ref = np.asarray(sample(volume, pos))
    # MOSTLY conservative near the surface: the bulk of near-surface
    # points underestimate (sphere tracing stays correct); the
    # overestimate tail comes from the empty-column arm inversion near
    # the narrowing top and is BOUNDED (measured p99 ~3.6 on a
    # 24x16x20 ellipsoid) — the honest contract the consumers
    # (collision thresholds ~1 unit, cone radii >= 4) are sized
    # against.
    near = np.abs(d_ref) < 4.0
    over = (d_cols - d_ref)[near]
    assert np.median(over) <= 0.25, np.median(over)
    assert np.percentile(over, 99) < 4.5, np.percentile(over, 99)


def test_gradient_matches_finite_difference():
    volume, _ = _field(_prism_env())
    cf = build_column_maps(volume, coarse=2)
    pos = _query_points(jax.random.key(4), 192, 96, n=512)
    d, g = sample_columns_grad(cf, pos)
    d = np.asarray(d)
    g = np.asarray(g)
    # eps must clear the bf16 map-pack noise floor (~0.25 absolute on
    # the height maps): at eps=0.05 the FD itself is ~2.5 noise.
    eps = 1.0
    for axis in range(3):
        dp = pos.at[:, axis].add(eps)
        dm = pos.at[:, axis].add(-eps)
        fd = (np.asarray(sample_columns(cf, dp))
              - np.asarray(sample_columns(cf, dm))) / (2 * eps)
        # Percentile-masked: finite differences straddle map-cell
        # boundaries and min/max seams where the true gradient jumps.
        err = np.abs(fd - g[:, axis])
        assert np.percentile(err, 80) < 0.3, (axis, np.percentile(err, 80))


def test_reconstruct_profile_matches_map_semantics():
    # reconstruct_profile(f, t, b, z) must equal the sampled
    # reconstruction when fed the same map values (the carried-scan
    # contract).
    f = jnp.asarray([-5.0, -1.0, 0.0, 3.0, 10.0])
    t = jnp.asarray([20.0, 8.0, 12.0, 6.0, 30.0])
    b = jnp.asarray([0.0, 0.0, 2.0, -4.0, 5.0])
    for z in (0.0, 5.0, 10.0, 25.0, 40.0):
        d = np.asarray(reconstruct_profile(f, t, b, jnp.float32(z)))
        dz = np.maximum(np.asarray(b) - z, z - np.asarray(t))
        fp = np.maximum(np.asarray(f), 0.0)
        dzp = np.maximum(dz, 0.0)
        want = (np.minimum(np.maximum(np.asarray(f), dz), 0.0)
                + np.hypot(fp, dzp))
        np.testing.assert_allclose(d, want, rtol=1e-5, atol=1e-5)


def test_resample_map_to_grid_alignment():
    volume, cfg = _field(_prism_env())
    cf = build_column_maps(volume, coarse=1)
    # Resampling onto the map's own texel centers must reproduce the
    # map (identity through the interp rows).
    H, W = cf.h_top.shape
    c = cf.config
    nscale = c.scale_x  # pixel centers (i+0.5)/nscale == texel centers
    out = resample_map_to_grid(cf, cf.h_top, H, W, nscale)
    np.testing.assert_allclose(np.asarray(out), np.asarray(cf.h_top),
                               rtol=1e-5, atol=1e-4)
