"""SDF auto-invalidation from obstruction dirty flags.

Reference behavior: AutoInvalidateDistanceField
(LightingRenderer.cs:1977-2015) — mutating a dynamic obstruction
invalidates only the dynamic partition of a DynamicDistanceField; static
mutations / list changes / dynamicity flips invalidate everything; the
per-frame budget (MaximumFieldUpdatesPerFrame) spreads regeneration.
"""

import numpy as np
import jax.numpy as jnp

from illuminant.core.config import RendererConfig
from illuminant.lighting.environment import (
    LightingEnvironment,
    LightObstruction,
)
from illuminant.lighting.renderer import LightingRenderer
from illuminant.sdf.sampling import sample
from illuminant.sdf.volume import SdfVolumeConfig


def _make(budget_all=True):
    env = LightingEnvironment(maximum_z=64.0)
    env.obstructions.append(
        LightObstruction.box((64.0, 64.0, 16.0), (10.0, 10.0, 16.0))
    )
    env.obstructions.append(
        LightObstruction.box((32.0, 32.0, 8.0), (6.0, 6.0, 8.0),
                             is_dynamic=True)
    )
    cfg = RendererConfig(width=128, height=128)
    sdf = SdfVolumeConfig(
        virtual_width=128, virtual_height=128, virtual_depth=32,
        slice_count=8, resolution_scale=0.5,
    )
    r = LightingRenderer(cfg, env, sdf_config=sdf)
    r.update_fields(budget=10 ** 6)  # fully valid
    assert r._invalid_static == [] and r._invalid_dynamic == []
    return env, r


def test_moving_dynamic_box_invalidates_only_dynamic_partition():
    env, r = _make()
    dyn = env.obstructions[1]
    dyn.center = (40.0, 32.0, 8.0)  # mutation sets the dirty flag
    r.auto_invalidate()
    assert r._invalid_static == []
    assert r._invalid_dynamic == list(range(8))


def test_moving_static_box_invalidates_everything():
    env, r = _make()
    env.obstructions[0].size = (12.0, 10.0, 16.0)
    r.auto_invalidate()
    assert r._invalid_static == list(range(8))
    assert r._invalid_dynamic == list(range(8))


def test_budget_spreads_regeneration_and_field_updates():
    env, r = _make()
    dyn = env.obstructions[1]
    dyn.center = (48.0, 32.0, 8.0)

    # Budget 1 = one 3-slice slab per frame; 8 slices -> 3 frames.
    r.update_fields(budget=1)
    assert len(r._invalid_dynamic) == 5
    assert r._invalid_static == []  # static untouched
    r.update_fields(budget=1)
    r.update_fields(budget=1)
    assert r._invalid_dynamic == []

    # The combined field reflects the move: near the NEW dynamic box
    # position the distance is small, near the old one it is larger.
    new_pos = jnp.asarray([[48.0, 32.0, 8.0]])
    old_pos = jnp.asarray([[16.0, 32.0, 8.0]])
    d_new = float(sample(r.volume, new_pos)[0])
    d_old = float(sample(r.volume, old_pos)[0])
    assert d_new < 0.0  # inside the moved box
    assert d_old > 4.0  # old location now empty

    # Static obstruction still present in the combined field.
    d_static = float(sample(r.volume, jnp.asarray([[64.0, 64.0, 16.0]]))[0])
    assert d_static < 0.0


def test_adding_dynamic_obstruction_invalidates_dynamic_only():
    env, r = _make()
    env.obstructions.append(
        LightObstruction.ellipsoid((90.0, 90.0, 8.0), (5.0, 5.0, 8.0),
                                   is_dynamic=True)
    )
    r.auto_invalidate()
    assert r._invalid_static == []
    assert r._invalid_dynamic == list(range(8))


def test_dynamicity_flip_invalidates_everything():
    env, r = _make()
    env.obstructions[1].is_dynamic = False
    r.auto_invalidate()
    assert r._invalid_static == list(range(8))


def test_untouched_scene_stays_valid():
    env, r = _make()
    r.auto_invalidate()
    assert r._invalid_static == [] and r._invalid_dynamic == []
