"""Scan shadows over a VOXEL field (loaded/polygonal paths) match the
analytic-scene scan on the same geometry."""

import numpy as np
import jax.numpy as jnp

from illuminant.core.config import QualitySettings
from illuminant.lighting.environment import (
    LightingEnvironment,
    LightObstruction,
)
from illuminant.lighting.scan_shadows import scan_visibility_jit as scan_visibility
from illuminant.sdf import volume as vol
from illuminant.sdf.analytic import pack_scene


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


def test_voxel_field_scan_matches_analytic():
    env = LightingEnvironment(maximum_z=64.0)
    env.obstructions.append(
        LightObstruction.box((128.0, 128.0, 16.0), (10.0, 40.0, 16.0))
    )
    cfg = vol.SdfVolumeConfig(
        virtual_width=256, virtual_height=256, virtual_depth=64,
        slice_count=16, resolution_scale=0.5,
    )
    field = vol.generate_volume(cfg, env.pack_obstructions())
    scene = pack_scene(env.obstructions)
    q = QualitySettings()
    args = (256, 256, jnp.asarray([[60.0, 128.0, 32.0]]),
            jnp.asarray([8.0]), jnp.asarray([200.0]), q)
    vis_vox = np.asarray(
        scan_visibility(field, *args, trace_z=jnp.float32(16.0)))[0]
    vis_ana = np.asarray(
        scan_visibility(scene, *args, trace_z=jnp.float32(16.0)))[0]
    # Voxel quantization at 2px resolution: agree within a loose band.
    assert np.abs(vis_vox - vis_ana).mean() < 0.02
    assert vis_vox[120:136, 160:220].max() < 0.1  # umbra dark
    assert vis_vox[30:60, 30:60].min() > 0.9  # open lit
