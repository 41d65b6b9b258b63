"""Gather-free sampling paths vs the gather oracle.

`sample` (sdf/sampling.py) is the reference-parity 8-tap gather
(sampleDistanceFieldEx, DistanceFieldCommon.fxh:313-353); the
interpolation-matrix path and the separable grid/stack path must match
it — exactly for the grid path, to bf16-relative precision for the matmul
path (the SDF's 1-Lipschitz property keeps the absolute error near
surfaces at ~2^-8 * |d|; see sampling.py module docstring).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from illuminant.lighting.environment import (
    LightingEnvironment,
    LightObstruction,
)
from illuminant.sdf import sampling, volume as vol
from illuminant.sdf.analytic import (
    scene_normal_p,
    scene_sample_p,
)


import pytest as _pytest

from illuminant.sdf import analytic as _analytic


@_pytest.fixture(autouse=True)
def _force_interp_dispatch():
    """This module pins the interpolation-matrix paths' semantics on
    the CPU backend, whose platform choice is the gather — force them
    (analytic._use_interp)."""
    prev = _analytic.set_interp_dispatch("always")
    yield
    _analytic.set_interp_dispatch(prev)


@pytest.fixture(scope="module")
def field():
    env = LightingEnvironment()
    env.obstructions = [
        LightObstruction.box((100.0, 80.0, 24.0), (40.0, 24.0, 24.0)),
        LightObstruction.cylinder((200.0, 160.0, 30.0),
                                  (18.0, 18.0, 30.0)),
        LightObstruction.ellipsoid((60.0, 200.0, 20.0),
                                   (30.0, 16.0, 20.0)),
    ]
    cfg = vol.SdfVolumeConfig(virtual_width=256, virtual_height=256,
                              virtual_depth=64, slice_count=16,
                              resolution_scale=0.5)
    return vol.generate_volume(cfg, env.pack_obstructions())


def _points(n, scale=(300.0, 300.0, 80.0), lo=(-20.0, -20.0, -8.0),
            seed=7):
    rng = np.random.default_rng(seed)
    p = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return jnp.asarray(p * np.asarray(scale) + np.asarray(lo))


def test_interp_matches_gather(field):
    pts = _points(4096)
    ref = np.asarray(sampling.sample(field, pts))
    fast = np.asarray(sampling.sample_interp(field, pts))
    err = np.abs(fast - ref)
    # Relative bf16 tolerance: |err| <= ~2^-7 * (|d| + voxel)
    tol = np.abs(ref) * 2.0 ** -7 + 0.05
    assert (err <= tol).all(), (err / np.maximum(np.abs(ref), 1.0)).max()
    # Near-surface queries (the ones that matter) are tight in absolute
    # terms.
    near = np.abs(ref) < 4.0
    assert near.any()
    assert err[near].max() < 0.06, err[near].max()


def test_interp_chunked_matches_single(field):
    # Cross the chunk boundary: padding/reshape must not corrupt order.
    n = sampling._INTERP_CHUNK + 1037
    pts = _points(n)
    ref = np.asarray(sampling.sample(field, pts))
    fast = np.asarray(sampling.sample_interp(field, pts))
    tol = np.abs(ref) * 2.0 ** -7 + 0.05
    assert (np.abs(fast - ref) <= tol).all()


def test_interp_grad_matches_finite_difference(field):
    pts = _points(1024, scale=(240.0, 240.0, 50.0), lo=(5.0, 5.0, 2.0),
                  seed=3)
    d, g = sampling.sample_interp_grad(field, pts)
    d = np.asarray(d)
    g = np.asarray(g)
    eps = 0.05
    for axis in range(3):
        off = np.zeros(3, np.float32)
        off[axis] = eps
        dp = np.asarray(sampling.sample(field, pts + off))
        dm = np.asarray(sampling.sample(field, pts - off))
        fd = (dp - dm) / (2 * eps)
        # Away from texel-cell boundaries the trilinear interpolant is
        # smooth; compare where the two one-sided samples agree (the
        # central difference straddles no kink).
        smooth = np.abs((dp + dm) / 2 - np.asarray(
            sampling.sample(field, pts))) < 1e-3
        err = np.abs(g[:, axis] - fd)[smooth]
        assert err.mean() < 0.03, (axis, err.mean())
        assert np.quantile(err, 0.95) < 0.2, (axis, np.quantile(err, .95))


def test_interp_grad_normal_matches_tetrahedral(field):
    # Direction check against the estimate_normal oracle near surfaces.
    pts = _points(2048, scale=(240.0, 240.0, 50.0), lo=(5.0, 5.0, 2.0),
                  seed=11)
    d = np.asarray(sampling.sample(field, pts))
    near = np.abs(d) < 8.0
    _, g = sampling.sample_interp_grad(field, pts)
    g = np.asarray(g)
    glen = np.linalg.norm(g, axis=-1)
    gn = g / np.maximum(glen[..., None], 1e-9)
    ref = np.asarray(sampling.estimate_normal(field, pts))
    # Compare where BOTH estimators produce a direction: the tetrahedral
    # oracle averages over a 2-voxel baseline while the interp gradient
    # is cell-local, so they legitimately diverge at cell corners and on
    # flat plateaus (zero local gradient). Collision only consumes the
    # normal at contact (|d| small), where both are well-defined.
    ok = (np.linalg.norm(ref, axis=-1) > 0.5) & (glen > 0.25) & near
    dot = (gn * ref).sum(-1)[ok]
    assert dot.mean() > 0.93, dot.mean()
    assert (dot > 0.7).mean() > 0.93, (dot > 0.7).mean()


def test_grid_matches_gather_exactly(field):
    xs = jnp.linspace(-10.0, 280.0, 97)
    ys = jnp.linspace(-5.0, 270.0, 83)
    z = jnp.float32(17.3)
    grid = np.asarray(sampling.sample_grid(field, xs, ys, z))
    pos = jnp.stack(jnp.broadcast_arrays(
        xs[None, :], ys[:, None], z), axis=-1)
    ref = np.asarray(sampling.sample(field, pos))
    assert np.abs(grid - ref).max() < 1e-3, np.abs(grid - ref).max()


def test_stack_z_per_query(field):
    xs = jnp.linspace(0.0, 256.0, 64)
    ys = jnp.linspace(0.0, 256.0, 48)
    z = jnp.asarray(
        np.random.default_rng(5).uniform(-10, 75, (2, 48, 64)),
        jnp.float32)
    stack = sampling.grid_stack(field, xs, ys)
    out = np.asarray(sampling.sample_stack_z(field, stack, xs, ys, z))
    pos = jnp.stack(jnp.broadcast_arrays(
        xs[None, None, :], ys[None, :, None], z), axis=-1)
    ref = np.asarray(sampling.sample(field, pos))
    assert np.abs(out - ref).max() < 1e-3, np.abs(out - ref).max()


def test_scene_sample_p_grid_dispatch(field):
    # The occlusion-image call shape: x (1, W), y (H, 1), scalar z.
    xs = jnp.linspace(2.0, 250.0, 40)
    ys = jnp.linspace(2.0, 250.0, 30)
    out = np.asarray(scene_sample_p(
        field, xs[None, :], ys[:, None], jnp.float32(12.0)))
    pos = jnp.stack(jnp.broadcast_arrays(
        xs[None, :], ys[:, None], jnp.float32(12.0)), axis=-1)
    ref = np.asarray(sampling.sample(field, pos))
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() < 1e-3


def test_scene_normal_p_fast_voxel(field):
    # Large scattered fast-normal batches route through the interp
    # gradient; result must be unit-ish and roughly match the oracle.
    pts = _points(sampling._INTERP_CHUNK // 2, seed=13)
    nx, ny, nz = scene_normal_p(field, pts[:, 0], pts[:, 1], pts[:, 2],
                                fast=True)
    n = np.stack([np.asarray(nx), np.asarray(ny), np.asarray(nz)], -1)
    ref = np.asarray(sampling.estimate_normal(field, pts))
    d = np.abs(np.asarray(sampling.sample(field, pts)))
    lens = np.linalg.norm(n, axis=-1)
    near = (d < 8.0) & (np.linalg.norm(ref, axis=-1) > 0.5) & (lens > 0.5)
    assert ((np.abs(lens - 1.0) < 1e-3) | (lens < 1e-3)).all()
    dot = (n * ref).sum(-1)[near]
    assert dot.mean() > 0.93, dot.mean()


def test_ao_stack_matches_scattered_on_flat_ground(field):
    from illuminant.lighting.sphere import compute_ao_p

    h, w = 64, 96
    xs = (jnp.arange(w, dtype=jnp.float32) + 0.5) * 2.0
    ys = (jnp.arange(h, dtype=jnp.float32) + 0.5) * 2.0
    wx = xs[None, None, :]
    wy = ys[None, :, None] + jnp.zeros((h, w), jnp.float32)[None]
    wz = jnp.zeros((1, h, w), jnp.float32)
    nz = jnp.ones((1, h, w), jnp.float32)
    ao_r = jnp.full((2, 1, 1), 16.0)
    ao_o = jnp.full((2, 1, 1), 0.8)
    vis = jnp.ones((2, h, w), bool)
    fast = np.asarray(compute_ao_p(field, wx, wy, wz, nz, ao_r, ao_o,
                                   vis, pixel_grid=(xs, ys)))
    ref = np.asarray(compute_ao_p(field, wx, wy, wz, nz, ao_r, ao_o,
                                  vis))
    assert np.abs(fast - ref).max() < 1e-3, np.abs(fast - ref).max()
