"""Lighting pipeline: falloff oracle, cone-traced shadows, full resolve."""

import numpy as np

from illuminant.core.config import QualitySettings, RendererConfig
from illuminant.lighting import cone_trace as ct
from illuminant.lighting import sphere as sph
from illuminant.lighting.environment import (
    LightObstruction,
    LightingEnvironment,
    SphereLightSource,
    pack_sphere_lights,
)
from illuminant.lighting.gbuffer import flat_ground
from illuminant.lighting.renderer import LightingRenderer, render_lightmap
from illuminant.sdf import volume as vol
from illuminant.ops import sdf_primitives as sp


def oracle_sphere_opacity(pos, normal, center, radius, ramp, mode,
                          y_factor=1.0, light_occlusion=0.0):
    """Independent numpy port of computeSphereLightOpacity
    (LightCommon.fxh:173-210)."""
    d3 = np.asarray(pos, np.float64) - np.asarray(center, np.float64)
    d3[1] *= y_factor
    dist = np.linalg.norm(d3)
    df = 1 - np.clip((dist - radius) / ramp, 0, 1)
    if light_occlusion > 0:
        df *= 1 - np.clip(d3[2] / light_occlusion, 0, 1)
    ln = d3 / dist
    if np.all(np.asarray(normal) == 0):
        nf = 1.0
    else:
        d = np.dot(-ln, normal)
        nf = np.clip((d + 0.15) / 0.15, 0, 1) ** 0.85
    if mode >= 2:
        df = 1 - np.clip(dist - radius, 0, 1)
        nf = 1.0
    elif mode >= 1:
        df *= df
    return np.clip(nf * df + np.clip(radius - dist, 0, 1), 0, 1)


def test_sphere_opacity_oracle():
    cases = [
        # pos, center, radius, ramp, mode
        ([100, 100, 0], [100, 100, 40], 10.0, 100.0, 0),
        ([150, 100, 0], [100, 100, 40], 10.0, 100.0, 0),
        ([100, 100, 0], [100, 100, 40], 10.0, 100.0, 1),
        ([105, 100, 35], [100, 100, 40], 30.0, 100.0, 0),  # inside radius
        ([300, 300, 0], [100, 100, 40], 10.0, 50.0, 0),  # out of range
    ]
    normal = np.asarray([0.0, 0.0, 1.0], np.float32)
    for pos, center, radius, ramp, mode in cases:
        props = np.asarray([[radius, ramp, float(mode), 1.0]], np.float32)
        got = float(
            sph.compute_sphere_light_opacity(
                np.asarray(pos, np.float32),
                normal,
                np.asarray(center, np.float32),
                props[0],
                np.float32(1.0),
                np.float32(0.0),
            )
        )
        want = oracle_sphere_opacity(pos, normal, center, radius, ramp, mode)
        np.testing.assert_allclose(got, want, atol=2e-3, err_msg=str(pos))


def _box_scene():
    """One box occluder between a light and the far side of the scene."""
    config = vol.SdfVolumeConfig(
        virtual_width=256, virtual_height=256, virtual_depth=64,
        slice_count=16, resolution_scale=0.5,
    )
    obs = vol.SdfObstructions.from_lists(
        types=[sp.TYPE_BOX],
        centers=[[128.0, 128.0, 16.0]],
        sizes=[[10.0, 40.0, 16.0]],
    )
    return vol.generate_volume(config, obs)


def test_cone_trace_shadow_vs_open():
    volume = _box_scene()
    q = QualitySettings()
    light = np.asarray([60.0, 128.0, 32.0], np.float32)
    # Point directly behind the box (from the light's view) vs one far off
    # to the side with a clear line of sight.
    shaded = np.asarray(
        [[200.0, 128.0, 1.0], [60.0, 30.0, 1.0]], np.float32
    )
    enable = np.asarray([True, True])
    vis = np.asarray(
        ct.cone_trace_jit(
            volume, light, np.float32(8.0), np.float32(200.0), shaded,
            enable, q,
        )
    )
    assert vis[0] < 0.05, f"behind the box should be shadowed, got {vis[0]}"
    assert vis[1] > 0.9, f"open path should be unshadowed, got {vis[1]}"


def test_cone_trace_disabled_is_one():
    volume = _box_scene()
    q = QualitySettings()
    light = np.asarray([60.0, 128.0, 32.0], np.float32)
    shaded = np.asarray([[200.0, 128.0, 1.0]], np.float32)
    vis = np.asarray(
        ct.cone_trace_jit(
            volume, light, np.float32(8.0), np.float32(200.0), shaded,
            np.asarray([False]), q,
        )
    )
    np.testing.assert_allclose(vis, [1.0])


def test_full_render_shadow_geometry():
    env = LightingEnvironment(ground_z=0.0, maximum_z=128.0,
                              ambient=(0.05, 0.05, 0.05, 1.0))
    env.lights.append(
        SphereLightSource(
            position=(60.0, 128.0, 32.0),
            radius=8.0,
            ramp_length=220.0,
            color=(1.0, 0.9, 0.8, 1.0),
        )
    )
    env.obstructions.append(
        LightObstruction.box((128.0, 128.0, 16.0), (10.0, 40.0, 16.0))
    )
    config = RendererConfig(width=256, height=256)
    sdf_config = vol.SdfVolumeConfig(
        virtual_width=256, virtual_height=256, virtual_depth=64,
        slice_count=16, resolution_scale=0.5,
    )
    r = LightingRenderer(config, env, sdf_config)
    r.update_fields(budget=100)  # generate the whole field
    lightmap = np.asarray(r.render_lighting())

    assert lightmap.shape == (256, 256, 4)
    near = lightmap[128, 70, :3].mean()  # next to the light
    shadow = lightmap[128, 180, :3].mean()  # behind the box
    side = lightmap[30, 60, :3].mean()  # clear line of sight
    assert near > 0.5, f"near the light should be lit: {near}"
    assert shadow < 0.08, f"behind the box should be dark: {shadow}"
    assert side > 0.1, f"open region should receive light: {side}"
    # Ambient floor everywhere.
    assert lightmap[..., :3].min() >= 0.05 - 1e-5


def test_incremental_field_updates_match_full():
    env = LightingEnvironment()
    env.obstructions.append(
        LightObstruction.ellipsoid((64.0, 64.0, 16.0), (20.0, 20.0, 12.0))
    )
    sdf_config = vol.SdfVolumeConfig(
        virtual_width=128, virtual_height=128, virtual_depth=32,
        slice_count=12, resolution_scale=0.5,
    )
    config = RendererConfig(width=128, height=128,
                            maximum_field_updates_per_frame=1)
    r = LightingRenderer(config, env, sdf_config)
    # 12 slices / 3 per update = 4 frames to converge.
    for _ in range(4):
        r.update_fields()
    assert not r._invalid_slices
    full = vol.generate_volume(
        sdf_config, env.pack_obstructions(capacity=64)
    )
    # Tolerance: slab and full generation compile to differently-fused
    # programs; identical math, ~1e-5 float noise.
    np.testing.assert_allclose(
        np.asarray(r.volume.data), np.asarray(full.data), atol=1e-3
    )
    np.testing.assert_allclose(
        float(r.volume.max_valid_z), float(full.max_valid_z)
    )


def test_resolve_modes_run():
    from illuminant.core.config import HDRConfig
    from illuminant.raster.resolve import resolve, to_uint8

    lightmap = np.random.default_rng(0).uniform(
        0, 4, size=(32, 32, 4)
    ).astype(np.float32)
    for mode in (0, 1, 2):
        out = np.asarray(
            resolve(lightmap, HDRConfig(mode=mode, exposure=1.2))
        )
        assert out.shape == (32, 32, 4)
        assert np.isfinite(out).all()
    albedo = np.random.default_rng(1).uniform(
        0, 1, size=(32, 32, 4)
    ).astype(np.float32)
    out = np.asarray(resolve(lightmap, HDRConfig(), albedo=albedo))
    assert out.shape == (32, 32, 4)
    img = np.asarray(to_uint8(out))
    assert img.dtype == np.uint8


def test_lut_resolve():
    from illuminant.raster.lut import (
        LUTBlendingConfiguration,
        identity_lut,
        lut_blended_resolve,
        sample_lut,
    )

    lut = identity_lut(16)
    rgb = np.random.default_rng(0).uniform(0, 1, (8, 8, 3)).astype(
        np.float32
    )
    out = np.asarray(sample_lut(lut, rgb))
    np.testing.assert_allclose(out, rgb, atol=1e-5)

    # A bright-look LUT that doubles red, blended by light level.
    bright = identity_lut(16).copy()
    bright[..., 0] = np.clip(bright[..., 0] * 2.0, 0, 1)
    albedo = np.full((4, 4, 4), 0.4, np.float32)
    dark_light = np.full((4, 4, 4), 0.0, np.float32)
    bright_light = np.full((4, 4, 4), 1.0, np.float32)
    cfg = LUTBlendingConfiguration(dark_lut=lut, bright_lut=bright,
                                   lut_only=True)
    out_dark = np.asarray(lut_blended_resolve(albedo, dark_light, cfg))
    out_bright = np.asarray(lut_blended_resolve(albedo, bright_light, cfg))
    np.testing.assert_allclose(out_dark[..., 0], 0.4, atol=1e-2)
    np.testing.assert_allclose(out_bright[..., 0], 0.8, atol=1e-2)
    np.testing.assert_allclose(out_bright[..., 1], 0.4, atol=1e-2)


def test_vector_warp():
    from illuminant.raster.warp import vector_warp

    bg = np.zeros((32, 32, 4), np.float32)
    bg[:, 16:, 0] = 1.0  # right half red
    field = np.full((32, 32, 4), 0.5, np.float32)
    field[..., 3] = 1.0
    field[:, 12:20, 0] = 1.0  # push +x in a central band
    out = np.asarray(vector_warp(bg, field, intensity=(6.0, 6.0, 0.0)))
    # In the band, pixels read 6px to the right: red edge shifts left.
    assert out[16, 12, 0] > 0.9  # was black, now samples red region
    assert out[16, 4, 0] == 0.0  # outside the band unchanged (black)
    np.testing.assert_allclose(out[16, 25, 0], 1.0, atol=1e-5)


def test_normal_refraction_identity_when_flat():
    from illuminant.raster.warp import normal_refraction_warp

    bg = np.random.default_rng(0).uniform(0, 1, (16, 16, 4)).astype(
        np.float32
    )
    flat = np.full((16, 16, 4), 0.5, np.float32)
    flat[..., 2] = 1.0  # straight-up normals (encoded)
    flat[..., 3] = 1.0
    out = np.asarray(normal_refraction_warp(bg, flat))
    np.testing.assert_allclose(out, bg, atol=1e-3)
