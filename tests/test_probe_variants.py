"""Probe variants for line / volumetric / projector lights.

The probe value at a point on the ground plane must equal the lightmap's
pixel there — the probe techniques ARE the light cores evaluated at probe
positions (LineLightProbe.fx, probe techniques in DirectionalLight.fx and
ProjectorLight.fx; here shared structurally via ProbePoints).
"""

import numpy as np
import jax.numpy as jnp

from illuminant.core.config import QualitySettings
from illuminant.lighting.environment import (
    LightObstruction,
    LightingEnvironment,
)
from illuminant.lighting import gbuffer as gbuf
from illuminant.lighting.line import LineLightSource, pack_line_lights
from illuminant.lighting.line import accumulate_line_lights_jit as accumulate_line_lights
from illuminant.lighting.probes import (
    LightProbe,
    evaluate_probes_jit as evaluate_probes,
    pack_probes,
)
from illuminant.lighting.projector import (
    ProjectorLightSource,
    accumulate_projector_lights_jit,
    pack_projector_lights,
)
from illuminant.lighting.volumetric import (
    VolumetricLightSource,
    accumulate_volumetric_lights_jit,
    pack_volumetric_lights,
)
from illuminant.sdf.analytic import pack_scene

H = W = 64


def _env():
    env = LightingEnvironment(maximum_z=64.0)
    env.obstructions.append(
        LightObstruction.box((40.0, 32.0, 8.0), (4.0, 10.0, 8.0))
    )
    return env, pack_scene(env.obstructions)


def _probe_pixels():
    # Probe positions at pixel centers on the ground plane.
    pix = [(10, 18), (33, 50), (56, 30)]
    probes = [
        LightProbe(position=(x + 0.5, y + 0.5, 0.0), normal=(0, 0, 1))
        for (y, x) in pix
    ]
    return pix, pack_probes(probes)


def test_line_light_probe_matches_lightmap():
    env, scene = _env()
    q = QualitySettings()
    lights = pack_line_lights([
        LineLightSource(start=(8.0, 8.0, 12.0), end=(56.0, 12.0, 12.0),
                        radius=3.0, color_start=(1.0, 0.4, 0.2, 1.0),
                        color_end=(0.2, 0.4, 1.0, 1.0)),
    ])
    gb = gbuf.flat_ground(H, W, env.uniforms())
    lm = np.asarray(
        accumulate_line_lights(scene, gb, lights, env.uniforms(), q)
    )
    pix, probes = _probe_pixels()
    vals = np.asarray(
        evaluate_probes(scene, probes, env.uniforms(), q,
                        line_lights=lights)
    )
    assert vals[:3].max() > 0.01  # actually lit
    for i, (y, x) in enumerate(pix):
        expected = lm[y, x] + np.asarray(env.uniforms().ambient)
        np.testing.assert_allclose(vals[i], expected, atol=2e-3)


def test_volumetric_light_probe_matches_lightmap():
    env, scene = _env()
    q = QualitySettings()
    lights = pack_volumetric_lights([
        VolumetricLightSource(start_position=(20.0, 30.0, 10.0),
                              end_position=(44.0, 34.0, 10.0),
                              start_radius=14.0, end_radius=8.0,
                              color=(0.9, 0.8, 0.5, 1.0)),
    ])
    gb = gbuf.flat_ground(H, W, env.uniforms())
    lm = np.asarray(
        accumulate_volumetric_lights_jit(scene, gb, lights, env.uniforms(), q)
    )
    pix, probes = _probe_pixels()
    vals = np.asarray(
        evaluate_probes(scene, probes, env.uniforms(), q,
                        volumetric_lights=lights)
    )
    assert vals[:3].max() > 0.001
    for i, (y, x) in enumerate(pix):
        expected = lm[y, x] + np.asarray(env.uniforms().ambient)
        np.testing.assert_allclose(vals[i], expected, atol=2e-3)


def test_projector_light_probe_matches_lightmap():
    env, scene = _env()
    q = QualitySettings()
    tex = np.zeros((8, 8, 4), np.float32)
    tex[:, :, 0] = np.linspace(0.2, 1.0, 8)[None, :]
    tex[:, :, 3] = 1.0
    lights = pack_projector_lights([
        ProjectorLightSource(texture=tex, position=(16.0, 16.0, 0.0),
                             scale=(4.0, 4.0)),
    ])
    gb = gbuf.flat_ground(H, W, env.uniforms())
    lm = np.asarray(
        accumulate_projector_lights_jit(scene, gb, lights, env.uniforms(), q)
    )
    pix, probes = _probe_pixels()
    vals = np.asarray(
        evaluate_probes(scene, probes, env.uniforms(), q,
                        projector_lights=lights)
    )
    for i, (y, x) in enumerate(pix):
        expected = lm[y, x] + np.asarray(env.uniforms().ambient)
        np.testing.assert_allclose(vals[i], expected, atol=2e-3)
