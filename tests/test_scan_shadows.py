"""Scan-shadow fast path vs the exact cone-trace march."""

import numpy as np
import jax.numpy as jnp

from illuminant.core.config import QualitySettings
from illuminant.lighting import cone_trace as ct
from illuminant.lighting.scan_shadows import scan_visibility_jit as scan_visibility
from illuminant.sdf.analytic import pack_scene
from illuminant.lighting.environment import LightObstruction


def _setup():
    scene = pack_scene(
        [LightObstruction.box((128.0, 128.0, 16.0), (10.0, 40.0, 16.0))]
    )
    q = QualitySettings()
    light = np.asarray([[60.0, 128.0, 32.0]], np.float32)
    return scene, q, light


def test_scan_matches_march_classification():
    scene, q, light = _setup()
    H = W = 256

    vis_scan = np.asarray(
        scan_visibility(
            scene, H, W, jnp.asarray(light),
            jnp.asarray([8.0]), jnp.asarray([200.0]), q,
            trace_z=jnp.float32(16.0),
        )
    )[0]

    ys, xs = np.meshgrid(
        np.arange(H, dtype=np.float32) + 0.5,
        np.arange(W, dtype=np.float32) + 0.5,
        indexing="ij",
    )
    shaded = np.stack(
        [xs, ys, np.full_like(xs, 16.0)], axis=-1
    ).astype(np.float32)
    vis_march = np.asarray(
        ct.cone_trace_jit(
            scene, jnp.asarray(light[0]), jnp.float32(8.0),
            jnp.float32(200.0), jnp.asarray(shaded),
            jnp.ones((H, W), bool), q,
        )
    )

    # Hard-shadow core behind the box must be dark in both.
    assert vis_scan[120:136, 160:220].max() < 0.05
    assert vis_march[120:136, 160:220].max() < 0.05
    # Open regions fully lit in both.
    assert vis_scan[30:60, 30:60].min() > 0.95
    assert vis_march[30:60, 30:60].min() > 0.95
    # Overall agreement: mean abs difference small over the whole image.
    diff = np.abs(vis_scan - vis_march)
    assert diff.mean() < 0.03, f"mean abs diff {diff.mean()}"
    # Penumbra must widen with distance from the occluder in the scan too
    # (cone growth): measure shadow width at two distances behind the box.
    def shadow_width(col):
        return (vis_scan[:, col] < 0.5).sum()

    assert shadow_width(250) >= shadow_width(150) - 1


def test_fast_stack_quarter_res_nomination_tracks_march():
    """The fast-preset shadow stack (shadow_scale 0.5 + nomination 0.5:
    the walk runs at QUARTER of the lightmap grid) must stay close to
    the exact march — the bound that justifies the library-default
    quality point."""
    from illuminant.lighting.gbuffer import flat_ground
    from illuminant.lighting.environment import EnvironmentUniforms
    from illuminant.lighting.scan_shadows import scan_cone_visibility

    scene, _, light = _setup()
    H = W = 256
    env = EnvironmentUniforms.make()
    gb = flat_ground(H, W, env)

    vis = {}
    for nom in (1.0, 0.5):
        q = QualitySettings(shadow_scale=0.5, scan_refine_samples=1,
                            scan_nomination_scale=nom)
        vis[nom] = np.asarray(scan_cone_visibility(
            scene, gb, jnp.asarray(light), jnp.asarray([8.0]),
            jnp.asarray([200.0]), q, trace_z=jnp.float32(16.0),
        )[0], np.float32)

    ys, xs = np.meshgrid(np.arange(H, dtype=np.float32) + 0.5,
                         np.arange(W, dtype=np.float32) + 0.5,
                         indexing="ij")
    # march at the same lifted endpoints as the gbuffer path (flat
    # ground: normal +z, z = ground).
    shaded = np.stack([xs, ys, np.full_like(xs, 1.6)], -1)
    vis_march = np.asarray(ct.cone_trace_jit(
        scene, jnp.asarray(light[0]), jnp.float32(8.0),
        jnp.float32(200.0), jnp.asarray(shaded.astype(np.float32)),
        jnp.ones((H, W), bool), QualitySettings(),
    ))
    err_half = np.abs(vis[1.0] - vis_march).mean()
    err_quarter = np.abs(vis[0.5] - vis_march).mean()
    # Quarter-res nomination adds at most a small increment over the
    # half-res stack's existing march error.
    assert err_quarter <= err_half + 0.01, (err_half, err_quarter)
    assert err_quarter < 0.05, err_quarter
    # Hard core still dark, open field still lit.
    assert vis[0.5][120:136, 170:220].max() < 0.1
    assert vis[0.5][30:60, 30:60].min() > 0.9


def test_scan_no_occluder_is_fully_lit():
    scene = pack_scene([])
    q = QualitySettings()
    vis = np.asarray(
        scan_visibility(
            scene, 64, 64, jnp.asarray([[32.0, 32.0, 20.0]]),
            jnp.asarray([4.0]), jnp.asarray([100.0]), q,
            trace_z=jnp.float32(8.0),
        )
    )[0]
    assert vis.min() > 0.99


def test_scan_multiple_lights_independent():
    scene, q, _ = _setup()
    lights = jnp.asarray(
        [[60.0, 128.0, 32.0], [250.0, 30.0, 32.0]], jnp.float32
    )
    vis = np.asarray(
        scan_visibility(
            scene, 256, 256, lights,
            jnp.asarray([8.0, 8.0]), jnp.asarray([200.0, 200.0]), q,
            trace_z=jnp.float32(16.0),
        )
    )
    # Light 0 shadows to the east of the box; light 1 (above-right) casts
    # a different shadow — the maps must differ.
    assert np.abs(vis[0] - vis[1]).max() > 0.5


def test_scan_3d_short_obstruction_rays_pass_over():
    # A SHORT wall must not shadow pixels whose ray to a HIGH light passes
    # over it — the 3D refinement evaluates the blocker at the true ray
    # height (the pure-2D scan over-shadowed here).
    scene = pack_scene(
        [LightObstruction.box((100.0, 64.0, 4.0), (4.0, 40.0, 4.0))]  # 8 tall
    )
    q = QualitySettings()
    light = jnp.asarray([[40.0, 64.0, 60.0]], jnp.float32)  # high light
    vis = np.asarray(
        scan_visibility(
            scene, 128, 192, light, jnp.asarray([6.0]),
            jnp.asarray([300.0]), q, trace_z=jnp.float32(2.0),
            pixel_z=jnp.zeros((128, 192), jnp.float32),
        )
    )[0]
    # Ground shadow of an 8-tall wall under a z=60 light ends at
    # x = 40 + 58.4 * 60/52 ~ 107.4; just behind the wall is shadowed,
    # past the penumbra the ray clears the wall top.
    near_behind = vis[64, 105]
    far_behind = vis[64, 125]
    assert near_behind < 0.35, near_behind
    assert far_behind > 0.8, far_behind

    # Exact march agreement at the far point.
    shaded = np.zeros((1, 3), np.float32)
    shaded[0] = [125.0, 64.0, 0.0]
    march = float(
        ct.cone_trace_jit(scene, light[0], jnp.float32(6.0),
                      jnp.float32(300.0), jnp.asarray(shaded),
                      jnp.asarray([True]), q)[0]
    )
    assert abs(far_behind - march) < 0.15, (far_behind, march)
