"""Budgeted dynamic-field regeneration.

Reference semantics: DistanceField tracks InvalidSlices
(DistanceField.cs:13-16), LightingRenderer marks slices dirtied by
obstruction bounds (LightingRenderer.DistanceField.cs:415-462) and
regenerates at most Configuration.MaximumFieldUpdatesPerFrame slices
per frame (LightingRenderer.Configuration.cs:87-91) — moving occluders
trail stale slices that catch up over the next frames.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from illuminant.ops import sdf_primitives as P
from illuminant.sdf import volume as vol


def _cfg(slices=12):
    return vol.SdfVolumeConfig(
        virtual_width=128, virtual_height=128, virtual_depth=96.0,
        slice_count=slices, resolution_scale=0.25,
        max_encoded_distance=64.0)


def _obs(n_dyn, z=40.0, x0=20.0):
    types = [P.TYPE_ELLIPSOID] * n_dyn
    centers = [(x0 + 8.0 * i, 64.0, z) for i in range(n_dyn)]
    sizes = [(6.0, 6.0, 6.0)] * n_dyn
    return vol.SdfObstructions.from_lists(types, centers, sizes,
                                          capacity=max(n_dyn, 16))


def test_invalidation_marks_only_band():
    cfg = _cfg()
    obs = _obs(1, z=40.0)
    mask = np.asarray(vol.invalid_slices_for_bounds(cfg, obs, band=4.0))
    zs = np.arange(cfg.slice_count) * cfg.slice_z_size
    half = np.sqrt(3 * 6.0 ** 2) + 4.0
    expect = np.abs(zs - 40.0) <= half
    np.testing.assert_array_equal(mask, expect)
    assert mask.any() and not mask.all()


def test_budgeted_regen_converges_to_full():
    """After ceil(n_invalid / budget) frames of a stationary set, the
    budgeted volume equals the one-shot full regen."""
    cfg = _cfg()
    obs_a = _obs(8, z=40.0)
    obs_b = jax.tree.map(lambda x: x, obs_a).replace(
        centers=obs_a.centers + jnp.asarray([15.0, -10.0, 0.0]))
    v = vol.generate_volume(cfg, obs_a)
    full_b = vol.generate_volume(cfg, obs_b)

    budget = 3
    # Exact convergence needs every slice whose VALUES changed: any
    # unclipped voxel is within (192/255)*m of a surface, so that band
    # covers them all (beyond it the clip plateau is move-invariant).
    band = (192.0 / 255.0) * cfg.max_encoded_distance + 1e-3
    invalid = (vol.invalid_slices_for_bounds(cfg, obs_a, band=band)
               | vol.invalid_slices_for_bounds(cfg, obs_b, band=band))
    n_invalid = int(jnp.sum(invalid))
    assert n_invalid > budget  # the test only means something if it lags

    step = jax.jit(lambda v_, inv: vol.regenerate_invalid_budgeted(
        v_, obs_b, inv, budget))
    frames = -(-n_invalid // budget)
    stale_seen = False
    for f in range(frames):
        v, invalid = step(v, invalid)
        if f == 0:
            # mid-flight: exactly budget slices cleared, the rest stale
            assert int(jnp.sum(invalid)) == n_invalid - budget
            stale_seen = True
    assert stale_seen
    assert int(jnp.sum(invalid)) == 0
    # atol: the traced-index z (idx * slice_z_size) rounds differently
    # from the static arange path by ~2e-5 world units.
    np.testing.assert_allclose(np.asarray(v.data), np.asarray(full_b.data),
                               atol=1e-4)


def test_staleness_is_old_field_not_garbage():
    """Un-regenerated slices hold the PREVIOUS field exactly (the
    reference's stale slices keep their last rasterization)."""
    cfg = _cfg()
    obs_a = _obs(2, z=30.0)
    obs_b = obs_a.replace(centers=obs_a.centers
                          + jnp.asarray([25.0, 0.0, 0.0]))
    v0 = vol.generate_volume(cfg, obs_a)
    invalid = vol.invalid_slices_for_bounds(cfg, obs_b, band=2.0)
    v1, inv1 = vol.regenerate_invalid_budgeted(v0, obs_b, invalid, budget=1)
    still = np.asarray(invalid) & np.asarray(inv1)  # not yet regenerated
    regen = np.asarray(invalid) & ~np.asarray(inv1)
    assert regen.sum() == 1 and still.sum() >= 1
    d0, d1 = np.asarray(v0.data), np.asarray(v1.data)
    np.testing.assert_array_equal(d1[still], d0[still])
    assert np.abs(d1[regen] - d0[regen]).max() > 1.0  # actually moved


@pytest.mark.parametrize("n_dyn", [2, 8, 16])
def test_budget_bounds_work_per_frame(n_dyn):
    """The per-frame regenerated slice count is the budget, independent
    of the dynamic obstruction count (cost sublinear in dyn count)."""
    cfg = _cfg(slices=16)
    obs = _obs(n_dyn, z=48.0)
    v = vol.generate_volume(cfg, obs)
    invalid = jnp.ones((cfg.slice_count,), bool)
    _, inv1 = vol.regenerate_invalid_budgeted(v, obs, invalid, budget=4)
    assert int(jnp.sum(invalid)) - int(jnp.sum(inv1)) == 4


def test_no_invalid_is_a_noop():
    cfg = _cfg()
    obs = _obs(1)
    v = vol.generate_volume(cfg, obs)
    v2, inv = vol.regenerate_invalid_budgeted(
        v, obs.replace(centers=obs.centers + 50.0),
        jnp.zeros((cfg.slice_count,), bool), budget=4)
    np.testing.assert_array_equal(np.asarray(v2.data), np.asarray(v.data))
    assert not bool(jnp.any(inv))
