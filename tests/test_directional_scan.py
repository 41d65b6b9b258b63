"""Directional-light scan shadows (far pseudo-center) vs the cone march.

The scan path treats parallel directional rays as the limit of the radial
scan with the light center pushed far along -direction
(DirectionalLight.fx:76-83 semantics: shadows traced toward
pixel - direction * ShadowTraceLength, with the trace-length cap).
"""

import numpy as np
import jax.numpy as jnp

from illuminant.core.config import QualitySettings
from illuminant.lighting.directional import (
    DirectionalLightSource,
    accumulate_directional_lights_jit as accumulate_directional_lights,
    pack_directional_lights,
)
from illuminant.lighting.environment import (
    EnvironmentUniforms,
    LightObstruction,
)
from illuminant.lighting.gbuffer import flat_ground
from illuminant.sdf.analytic import pack_scene


def _setup(trace_length=300.0, direction=(-1.0, 0.0, -0.3)):
    scene = pack_scene(
        [LightObstruction.box((128.0, 128.0, 16.0), (10.0, 40.0, 24.0))]
    )
    env = EnvironmentUniforms.make()
    gb = flat_ground(256, 256, env)
    lights = pack_directional_lights([
        DirectionalLightSource(
            direction=direction,
            shadow_trace_length=trace_length,
            shadow_softness=8.0,
            shadow_ramp_rate=1.0,
        )
    ])
    q = QualitySettings()
    return scene, gb, lights, env, q


_MAP_CACHE = {}


def _shadow_map(shadow_mode, **kw):
    # The default-args march/scan maps are reused by several tests —
    # cache them (the 256^2 march is the file's dominant cost).
    key = (shadow_mode, tuple(sorted(kw.items())))
    if key not in _MAP_CACHE:
        scene, gb, lights, env, q = _setup(**kw)
        out = accumulate_directional_lights(
            scene, gb, lights, env, q, shadow_mode=shadow_mode
        )
        _MAP_CACHE[key] = np.asarray(out[..., 3])
    return _MAP_CACHE[key]


def test_directional_scan_matches_march_classification():
    """Light from the +x side (direction -x, shallow z slope): the shadow
    streak extends WEST of the box (along the direction vector) in both
    the march and the scan; the east side faces the light and stays lit."""
    a_march = _shadow_map("march")
    a_scan = _shadow_map("scan")

    # Both paths: dark core just west of the box, lit on the light side.
    for a in (a_march, a_scan):
        assert a[120:136, 70:110].max() < 0.10, a[120:136, 70:110].max()
        assert a[120:136, 150:200].min() > 0.5

    # Classification agreement (lit vs shadowed at 0.5 x open-field
    # level) over the whole frame, minus a small penumbra disagreement
    # allowance.
    open_lvl = a_march[20:60, 20:60].mean()
    cls_m = a_march > 0.5 * open_lvl
    cls_s = a_scan > 0.5 * open_lvl
    assert (cls_m != cls_s).mean() < 0.02, (cls_m != cls_s).mean()


def test_directional_scan_respects_trace_length():
    """Pixels whose blocker is farther than ShadowTraceLength along the
    ray are NOT shadowed (DirectionalLightSource.ShadowTraceLength)."""
    a_long = _shadow_map("scan", trace_length=400.0)
    a_short = _shadow_map("scan", trace_length=60.0)

    # Near the box (blocker ~15px along the ray): shadowed in both.
    assert a_long[120:136, 100:112].max() < 0.15
    assert a_short[120:136, 100:112].max() < 0.25
    # Far down-ray (blocker ~90px along the ray): only the long trace
    # shadows it.
    assert a_long[120:136, 15:40].mean() < 0.6
    assert a_short[120:136, 15:40].min() > 0.6


def test_directional_scan_diagonal_direction():
    """A diagonal direction exercises the N/S sector passes too; the
    shadow must extend along +x,+y (opposite the light direction)."""
    a = _shadow_map("scan", direction=(-0.7, -0.7, -0.3))
    # Down-ray of the box along the diagonal (-x, -y of the box).
    assert a[70:95, 70:95].mean() < a[165:185, 165:185].mean() * 0.6


def test_directional_ambient_no_direction_unshadowed():
    """direction=None is a pure ambient term: no shadowing on either
    path (trace_enable gates on the has-direction flag)."""
    scene = pack_scene(
        [LightObstruction.box((48.0, 48.0, 16.0), (10.0, 20.0, 24.0))]
    )
    env = EnvironmentUniforms.make()
    gb = flat_ground(64, 64, env)
    lights = pack_directional_lights(
        [DirectionalLightSource(direction=None)]
    )
    q = QualitySettings()
    a = np.asarray(accumulate_directional_lights(
        scene, gb, lights, env, q, shadow_mode="scan"
    )[..., 3])
    assert a.min() > 0.9


def test_directional_fused_shared_trace_plane():
    """The fused multi-family scan (scenes.py) runs the sun's pseudo-
    center lane on a SHARED trace plane pinned to the radial lights'
    height instead of the directional family's own plane. Over-
    nomination is safe (the 3D refine rejects blockers the climbing ray
    clears) — the classification must still agree with the march."""
    from illuminant.lighting.directional import directional_scan_args
    from illuminant.lighting.scan_shadows import scan_cone_visibility

    scene, gb, lights, env, q = _setup()
    centers, rad, ramp, mtd, _plane = directional_scan_args(
        gb, lights, env)
    # Sphere-style shared plane: lights at z=40 -> plane 16 (well below
    # the box top at 40; the directional's own plane would sit higher).
    vis = np.asarray(scan_cone_visibility(
        scene, gb, centers, rad, ramp, q,
        max_trace_distance=mtd, trace_z=jnp.asarray(16.0),
        self_occlusion_lift=jnp.asarray([1.5], jnp.float32),
    )[0])
    a_march = _shadow_map("march")
    # Dark core west of the box, lit on the light side (the march's
    # classification test).
    assert vis[120:136, 70:110].max() < 0.15, vis[120:136, 70:110].max()
    assert vis[120:136, 150:200].min() > 0.5
    open_lvl = a_march[20:60, 20:60].mean()
    cls = (a_march > 0.5 * open_lvl) != (vis > 0.5)
    assert cls.mean() < 0.03, cls.mean()


def test_line_light_scan_matches_march():
    """Line-light scan mode (3 anchors blended by u) agrees with the
    3-ray march on lit/shadow classification."""
    from illuminant.lighting.line import (
        LineLightSource,
        accumulate_line_lights_jit,
        pack_line_lights,
    )

    scene = pack_scene(
        [LightObstruction.box((128.0, 100.0, 16.0), (30.0, 8.0, 24.0))]
    )
    env = EnvironmentUniforms.make()
    gb = flat_ground(256, 256, env)
    lights = pack_line_lights([
        LineLightSource(start=(60.0, 40.0, 30.0), end=(200.0, 40.0, 30.0),
                        radius=8.0)
    ])
    q = QualitySettings()
    a_m = np.asarray(accumulate_line_lights_jit(
        scene, gb, lights, env, q, shadow_mode="march")[..., 3])
    a_s = np.asarray(accumulate_line_lights_jit(
        scene, gb, lights, env, q, shadow_mode="scan")[..., 3])

    # Shadow south of the bar in both; lit next to the segment.
    for a in (a_m, a_s):
        assert a[140:180, 110:145].max() < a[50:70, 110:145].mean() * 0.3
    lvl = a_m[50:70, 110:145].mean()
    cls = (a_m > 0.3 * lvl) != (a_s > 0.3 * lvl)
    assert cls.mean() < 0.06, cls.mean()
