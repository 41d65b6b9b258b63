"""Round-3 third self-review batch regression tests.

1. Nomination-grid radius rescale: the scan's near-light sample skip
   (`dx > radius`, mirroring the trace stopping `radius` short of the
   light — ConeTrace.fxh:46) must compare in NOMINATION-GRID pixels.
   Before the fix, the world-unit radius carved a radius/nscale dead
   zone: at the library defaults (shadow_scale 0.5 x nomination 0.5) an
   occluder 20 world units from a radius-8 light cast NO shadow.
2. Projector window centers are scaled to pixels at the scenes.py call
   site (accumulate_windowed takes pixel coordinates).
3. scan_cone_visibility's fused array-lift path (resize-then-lift)
   matches the scalar lift-then-resize path per lane.
"""

import numpy as np
import jax.numpy as jnp

from illuminant.core.config import QualitySettings
from illuminant.lighting.environment import LightObstruction
from illuminant.lighting.scan_shadows import (
    scan_cone_visibility, scan_visibility_jit)
from illuminant.sdf.analytic import pack_scene


def _box_scene(cx=44.0, cy=32.0):
    return pack_scene([
        LightObstruction.box((cx, cy, 6.0), (3.0, 3.0, 6.0)),
    ])


def test_near_light_occluder_casts_shadow_at_default_quality():
    # Light at (24, 32, 20), radius 8; box occluder 20 world units away.
    # Default QualitySettings: shadow_scale 0.5 and nomination 0.5 give
    # nscale 0.25 — pre-fix the skip radius covered 8/0.25 = 32 px and
    # the occluder column never merged (band fully lit).
    scene = _box_scene()
    h, w = 64, 128
    q = QualitySettings()
    assert q.shadow_scale * q.scan_nomination_scale < 1.0
    nscale = q.shadow_scale * q.scan_nomination_scale
    light = jnp.asarray([[24.0, 32.0, 20.0]], jnp.float32)
    radius = jnp.asarray([8.0], jnp.float32)
    ramp = jnp.asarray([32.0], jnp.float32)
    sh, sw = int(h * q.shadow_scale), int(w * q.shadow_scale)
    vis = np.asarray(scan_visibility_jit(
        scene, sh, sw, light, radius, ramp, q,
        render_scale=q.shadow_scale, trace_z=jnp.asarray(6.0),
    ))
    # The shadow band behind the box (x in (47, 80) world = scaled px),
    # at the light's y row.
    row = int(32 * q.shadow_scale)
    band = vis[0, row, int(50 * q.shadow_scale):int(78 * q.shadow_scale)]
    assert band.min() < 0.25, (
        f"near-light occluder casts no shadow (min {band.min():.3f}, "
        f"nscale {nscale})")


def test_scan_radius_skip_matches_world_units():
    # The skip zone should end ~radius world units past the light
    # REGARDLESS of nomination scale: visibility at the light's own
    # column stays lit (occluder is outside the radius), matching the
    # nomination=1.0 result.
    scene = _box_scene()
    h, w = 64, 128
    light = jnp.asarray([[24.0, 32.0, 20.0]], jnp.float32)
    radius = jnp.asarray([8.0], jnp.float32)
    ramp = jnp.asarray([32.0], jnp.float32)
    q1 = QualitySettings(shadow_scale=1.0, scan_nomination_scale=1.0)
    qn = QualitySettings(shadow_scale=1.0, scan_nomination_scale=0.5)
    v1 = np.asarray(scan_visibility_jit(
        scene, h, w, light, radius, ramp, q1, render_scale=1.0,
        trace_z=jnp.asarray(6.0)))
    vn = np.asarray(scan_visibility_jit(
        scene, h, w, light, radius, ramp, qn, render_scale=1.0,
        trace_z=jnp.asarray(6.0)))
    row = 32
    # Same umbra: both nominate the box and darken the band.
    assert v1[0, row, 50:78].min() < 0.25
    assert vn[0, row, 50:78].min() < 0.25
    assert abs(float(v1[0, row, 50:78].mean())
               - float(vn[0, row, 50:78].mean())) < 0.2


def test_fused_array_lift_matches_scalar_lift():
    # scan_cone_visibility with lift=[1.6, 1.5] must equal two scalar
    # calls (resize-then-lift == lift-then-resize up to f32 rounding).
    from illuminant.lighting.gbuffer import flat_ground
    from illuminant.lighting.environment import (
        LightingEnvironment)

    scene = _box_scene()
    h, w = 64, 128
    env = LightingEnvironment(ground_z=0.0, maximum_z=40.0)
    gb = flat_ground(h, w, env.uniforms())
    lights = jnp.asarray(
        [[24.0, 32.0, 20.0], [100.0, 40.0, 24.0]], jnp.float32)
    radius = jnp.asarray([8.0, 6.0], jnp.float32)
    ramp = jnp.asarray([32.0, 24.0], jnp.float32)
    q = QualitySettings(shadow_scale=0.5, scan_nomination_scale=1.0)
    # Pin trace_z: fused and solo calls otherwise derive it from the
    # mean light height, which differs between the L=2 and L=1 sets.
    tz = jnp.asarray(8.0)
    fused = scan_cone_visibility(
        scene, gb, lights, radius, ramp, q, trace_z=tz,
        self_occlusion_lift=jnp.asarray([1.6, 1.5], jnp.float32))
    for i, lift in enumerate((1.6, 1.5)):
        solo = scan_cone_visibility(
            scene, gb, lights[i:i + 1], radius[i:i + 1], ramp[i:i + 1],
            q, trace_z=tz, self_occlusion_lift=lift)
        d = np.abs(np.asarray(fused[i], np.float32)
                   - np.asarray(solo[0], np.float32))
        assert d.max() < 2e-2, (i, d.max())


def test_projector_window_centers_scaled_to_pixels():
    # scenes.py multiplies projector window centers by render_scale at
    # the accumulate_windowed call; pin the call-site contract by
    # checking window_origin lands the window on the projected quad.
    import inspect
    from illuminant import scenes

    src = inspect.getsource(scenes)
    at = src.index("projector_centers\"]", src.index("accumulate_windowed"))
    assert "render_scale" in src[at:at + 120], (
        "projector window centers must be scaled to pixels")


def test_compound_umbra_bounds():
    """3-occluder crossing-shadow scene (the scan approximation's
    documented worst case): the depth-gated refine candidate + near-
    surface exit band + exit-low flatland clamp keep the error vs the
    exact march bounded — mean < 0.035 and < 2% of pixels off by more
    than 0.8 at the library-default quality (was mean 0.080 with whole
    slivers at error 1.0 before the round-3 fixes)."""
    from illuminant.lighting import cone_trace as ct

    H, W = 192, 192
    scene = pack_scene([
        LightObstruction.box((96.0, 96.0, 18.0), (8.0, 28.0, 18.0)),
        LightObstruction.cylinder((140.0, 60.0, 24.0), (9.0, 9.0, 24.0)),
        LightObstruction.box((60.0, 140.0, 6.0), (14.0, 8.0, 6.0)),
    ])
    light = jnp.asarray([[40.0, 100.0, 30.0]])
    ys, xs = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5,
                         indexing="ij")
    shaded = np.stack([xs, ys, np.zeros_like(xs)], -1).astype(np.float32)
    march = np.asarray(ct.cone_trace_jit(
        scene, light[0], jnp.float32(7.0), jnp.float32(220.0),
        jnp.asarray(shaded), jnp.ones((H, W), bool), QualitySettings()))
    q = QualitySettings(scan_refine_samples=1)  # library default nom 0.5
    vis = np.asarray(scan_visibility_jit(
        scene, H, W, light, jnp.asarray([7.0]), jnp.asarray([220.0]),
        q, pixel_z=jnp.zeros((H, W))))[0]
    d = np.abs(vis - march)
    assert d.mean() < 0.035, d.mean()
    assert (d > 0.8).mean() < 0.02, (d > 0.8).mean()
    # The parity-class knobs must do at least as well.
    q2 = QualitySettings(scan_refine_samples=2)
    vis2 = np.asarray(scan_visibility_jit(
        scene, H, W, light, jnp.asarray([7.0]), jnp.asarray([220.0]),
        q2, pixel_z=jnp.zeros((H, W))))[0]
    d2 = np.abs(vis2 - march)
    assert d2.mean() < 0.02, d2.mean()
    assert (d2 > 0.8).mean() < 0.005, (d2 > 0.8).mean()
