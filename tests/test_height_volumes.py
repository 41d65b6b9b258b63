"""Height volumes: polygon SDF, G-buffer rasterization, 2.5D lighting."""

import numpy as np
import jax.numpy as jnp

from illuminant.core.config import RendererConfig
from illuminant.lighting.environment import (
    LightingEnvironment,
    SphereLightSource,
)
from illuminant.lighting.gbuffer import flat_ground
from illuminant.lighting.height_volume import rasterize_height_volumes
from illuminant.lighting.renderer import LightingRenderer
from illuminant.sdf.height_volume import (
    HeightVolume,
    extruded_polygon_distance,
    pack_height_volumes,
    polygon_sdf_2d,
    POLYGON_XY_BIAS,
)

SQUARE = [(10.0, 10.0), (50.0, 10.0), (50.0, 40.0), (10.0, 40.0)]


def test_polygon_sdf_square():
    vols = pack_height_volumes([HeightVolume(polygon=SQUARE)])
    pts = np.asarray(
        [[30.0, 25.0], [60.0, 25.0], [30.0, 0.0], [0.0, 0.0]], np.float32
    )
    d = np.asarray(
        polygon_sdf_2d(pts[:, None, :],
                       np.asarray(vols.vertices)[0][None],
                       np.asarray(vols.next_vertices)[0][None])
    )[:, 0]
    np.testing.assert_allclose(d[0], -15.0, atol=1e-4)  # inside
    np.testing.assert_allclose(d[1], 10.0, atol=1e-4)  # right of edge
    np.testing.assert_allclose(d[2], 10.0, atol=1e-4)  # below
    np.testing.assert_allclose(d[3], np.sqrt(200.0), atol=1e-3)  # corner


def test_polygon_sdf_concave():
    # L-shape: the notch point must be OUTSIDE.
    lshape = [(0.0, 0.0), (40.0, 0.0), (40.0, 20.0), (20.0, 20.0),
              (20.0, 40.0), (0.0, 40.0)]
    vols = pack_height_volumes([HeightVolume(polygon=lshape)],
                               max_edges=8)
    pts = np.asarray([[10.0, 10.0], [30.0, 30.0]], np.float32)
    d = np.asarray(
        polygon_sdf_2d(pts[:, None, :],
                       np.asarray(vols.vertices)[0][None],
                       np.asarray(vols.next_vertices)[0][None])
    )[:, 0]
    assert d[0] < 0  # in the solid part
    assert d[1] > 0  # in the notch


def test_extruded_distance():
    vols = pack_height_volumes(
        [HeightVolume(polygon=SQUARE, z_base=0.0, height=20.0)]
    )
    inside = np.asarray([[30.0, 25.0, 10.0]], np.float32)
    above = np.asarray([[30.0, 25.0, 35.0]], np.float32)
    d_in = float(extruded_polygon_distance(inside, vols)[0])
    d_up = float(extruded_polygon_distance(above, vols)[0])
    assert d_in < 0, d_in  # inside (xy bias shrinks the interior slightly)
    np.testing.assert_allclose(d_up, 15.0, atol=0.1)


def test_gbuffer_top_and_front_faces():
    env = LightingEnvironment(z_to_y_multiplier=1.0, maximum_z=64.0)
    env_u = env.uniforms()
    gb = flat_ground(96, 96, env_u)
    vols = pack_height_volumes(
        [HeightVolume(polygon=SQUARE, z_base=0.0, height=20.0)]
    )
    out = rasterize_height_volumes(gb, vols, env_u, self_occlusion_z=0.0)
    z = np.asarray(out.z)
    n = np.asarray(out.normal)
    # Top face appears displaced up-screen by zToY*z_top = 20:
    # polygon y in [10,40] -> screen y in [-10, 20].
    assert abs(z[15, 30] - 20.0) < 1e-3, z[15, 30]
    np.testing.assert_allclose(n[15, 30], [0, 0, 1], atol=1e-5)
    # Front face band: south edge at world y=40 spans screen y in [20, 40]
    # with z interpolating 20..0 (z = 40 - sy).
    assert abs(z[25, 30] - 15.0) < 1.0, z[25, 30]
    assert n[25, 30, 1] > 0.9, n[25, 30]  # south-facing normal
    # Outside the volume: untouched ground.
    assert z[80, 80] == 0.0
    # relativeY equals z * zToY on the volume (GBuffer.fx:85).
    ry = np.asarray(out.relative_y)
    assert abs(ry[15, 30] - 20.0) < 1e-3


def test_height_volume_shadows_in_scene():
    # A height-volume wall must cast scan shadows like a box obstruction.
    env = LightingEnvironment(ambient=(0.02, 0.02, 0.02, 1.0))
    env.lights.append(
        SphereLightSource(position=(40.0, 64.0, 30.0), radius=6.0,
                          ramp_length=200.0)
    )
    env.height_volumes.append(
        HeightVolume(polygon=[(70.0, 30.0), (80.0, 30.0), (80.0, 100.0),
                              (70.0, 100.0)], z_base=0.0, height=30.0)
    )
    r = LightingRenderer(RendererConfig(width=128, height=128), env, None)
    r.update_fields()
    lm = np.asarray(r.render_lighting(shadow_mode="scan"))
    lit = lm[64, 30, :3].mean()
    shadowed = lm[64, 110, :3].mean()
    assert lit > 0.3, lit
    assert shadowed < lit * 0.2, (lit, shadowed)


def test_billboard_mask_writes_gbuffer():
    from illuminant.lighting.billboard import Billboard, rasterize_billboards

    env = LightingEnvironment(z_to_y_multiplier=1.0)
    env_u = env.uniforms()
    gb = flat_ground(64, 64, env_u)
    tex = np.zeros((8, 8, 4), np.float32)
    tex[:, 2:6, 3] = 1.0  # opaque vertical stripe
    b = Billboard(screen_bounds=(16.0, 16.0, 48.0, 48.0), texture=tex,
                  normal=(0.0, 1.0, 0.0), cylinder_factor=0.0)
    out = rasterize_billboards(gb, [b], env_u)
    z = np.asarray(out.z)
    n = np.asarray(out.normal)
    # Inside the opaque stripe: standing normal (0,1,0), z rises upward.
    assert n[32, 32, 1] > 0.9
    assert z[20, 32] > z[44, 32] > 0.0  # higher on screen = taller
    # Outside the stripe alpha: untouched ground.
    assert z[32, 20] == 0.0 and n[32, 20, 2] == 1.0
    # relativeY anchors lighting at the bottom edge.
    ry = np.asarray(out.relative_y)
    assert abs(ry[32, 32] - (48.0 - 32.5)) < 1.0
