"""Per-light BlendMode composition (LightSource.cs:65): the renderer
batches same-blend lights and composes additive / subtractive / max
groups like the reference's blend-keyed render states
(LightingRenderer.cs:206; demo usages ProjectorLight.cs:321 subtractive,
TwoPointFiveD.cs:307 max)."""

import numpy as np
import jax.numpy as jnp

from illuminant.core.config import RendererConfig
from illuminant.lighting.directional import DirectionalLightSource
from illuminant.lighting.environment import (
    LightObstruction,
    LightingEnvironment,
    SphereLightSource,
)
from illuminant.lighting.renderer import LightingRenderer


def _renderer(lights):
    env = LightingEnvironment(ground_z=0.0, maximum_z=64.0,
                              ambient=(0.05, 0.05, 0.05, 1.0))
    env.obstructions.append(
        LightObstruction.box((40.0, 32.0, 8.0), (6.0, 6.0, 8.0)))
    env.lights.extend(lights)
    return LightingRenderer(
        RendererConfig(width=96, height=64), env, None)


BASE = dict(radius=4.0, ramp_length=40.0, cast_shadows=False)


def test_subtractive_light_darkens():
    add = SphereLightSource(position=(30.0, 32.0, 20.0),
                            color=(1.0, 1.0, 1.0, 0.8), **BASE)
    dark = SphereLightSource(position=(60.0, 32.0, 20.0),
                             color=(1.0, 1.0, 1.0, 0.5),
                             blend_mode="subtractive", **BASE)
    lm_plain = np.asarray(_renderer([add]).render_lighting(
        shadow_mode="scan"))
    lm_dark = np.asarray(_renderer([add, dark]).render_lighting(
        shadow_mode="scan"))
    # Near the darkness light the map must be strictly darker; far away
    # (outside its ramp) unchanged.
    assert lm_dark[32, 60, :3].sum() < lm_plain[32, 60, :3].sum() - 0.05
    assert np.allclose(lm_dark[32, 2], lm_plain[32, 2], atol=1e-5)
    # Subtraction is unclamped pre-resolve (float lightmap semantics).
    assert (lm_dark <= lm_plain + 1e-5).all()


def test_max_light_is_a_floor():
    add = SphereLightSource(position=(30.0, 32.0, 20.0),
                            color=(1.0, 1.0, 1.0, 0.3), **BASE)
    mx = DirectionalLightSource(direction=(-0.4, -0.4, -0.8),
                                color=(0.2, 0.2, 0.25, 0.4),
                                cast_shadows=False, blend_mode="max")
    add_dir = DirectionalLightSource(direction=(-0.4, -0.4, -0.8),
                                     color=(0.2, 0.2, 0.25, 0.4),
                                     cast_shadows=False)
    lm_plain = np.asarray(_renderer([add]).render_lighting(
        shadow_mode="scan"))
    lm = np.asarray(_renderer([add, mx]).render_lighting(
        shadow_mode="scan"))
    # The pure max-group contribution = an additive-blend run of the
    # same directional light with zero ambient.
    def _dark_renderer(lights):
        env = LightingEnvironment(ground_z=0.0, maximum_z=64.0,
                                  ambient=(0.0, 0.0, 0.0, 0.0))
        env.obstructions.append(
            LightObstruction.box((40.0, 32.0, 8.0), (6.0, 6.0, 8.0)))
        env.lights.extend(lights)
        return LightingRenderer(
            RendererConfig(width=96, height=64), env, None)

    dir_full = np.asarray(_dark_renderer([add_dir]).render_lighting(
        shadow_mode="scan"))
    expected = np.maximum(lm_plain, dir_full)
    assert np.abs(lm - expected).max() < 1e-4
    # The floor engages (ambient-ish pixels rise to the directional
    # value) and is NOT additive (far pixels equal the max, not the sum).
    assert (lm > lm_plain + 1e-5).any()
    far = lm[32, 2, :3]
    assert np.allclose(far, np.maximum(lm_plain[32, 2, :3],
                                       dir_full[32, 2, :3]), atol=1e-5)


def test_additive_only_path_unchanged():
    # No sub/max lights -> single pass, identical to the historic path.
    add = SphereLightSource(position=(30.0, 32.0, 20.0),
                            color=(1.0, 0.9, 0.8, 0.6), **BASE)
    lm1 = np.asarray(_renderer([add]).render_lighting(shadow_mode="scan"))
    lm2 = np.asarray(_renderer([add]).render_lighting(shadow_mode="scan"))
    assert np.array_equal(lm1, lm2)
    assert lm1.shape == (64, 96, 4)


def test_two_max_lights_compose_as_max_not_sum():
    # MaxBlendValue applies per draw: two overlapping max lights give
    # max(base, A, B), never max(base, A + B).
    mx_a = DirectionalLightSource(direction=(-0.4, -0.4, -0.8),
                                  color=(0.2, 0.2, 0.25, 0.4),
                                  cast_shadows=False, blend_mode="max")
    mx_b = DirectionalLightSource(direction=(-0.4, -0.4, -0.8),
                                  color=(0.2, 0.2, 0.25, 0.4),
                                  cast_shadows=False, blend_mode="max")
    lm1 = np.asarray(_renderer([mx_a]).render_lighting(
        shadow_mode="scan"))
    lm2 = np.asarray(_renderer([mx_a, mx_b]).render_lighting(
        shadow_mode="scan"))
    assert np.abs(lm2 - lm1).max() < 1e-5, (
        "identical max lights must be idempotent")


def test_unknown_blend_mode_raises():
    import pytest

    bad = SphereLightSource(position=(30.0, 32.0, 20.0),
                            color=(1.0, 1.0, 1.0, 0.8),
                            blend_mode="Additive", **BASE)
    with pytest.raises(ValueError, match="blend_mode"):
        _renderer([bad]).render_lighting(shadow_mode="scan")
