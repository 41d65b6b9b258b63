"""AutoGBufferBitmap / NormalBillboard parity (AutoGBufferBitmap.fx)."""

import numpy as np

from illuminant.lighting.billboard import (
    Billboard,
    TYPE_AUTO,
    TYPE_NORMAL_BILLBOARD,
    rasterize_billboards,
)
from illuminant.lighting import gbuffer as gbuf
from illuminant.lighting.environment import LightingEnvironment


def _gb():
    env = LightingEnvironment(z_to_y_multiplier=1.0)
    return env, gbuf.flat_ground(64, 64, env.uniforms())


def test_auto_gbuffer_sprite_infers_normal_and_z():
    env, gb = _gb()
    tex = np.zeros((8, 8, 4), np.float32)
    tex[2:6, 2:6, 3] = 1.0  # sprite silhouette
    b = Billboard(screen_bounds=(16, 16, 32, 32), texture=tex,
                  type=TYPE_AUTO, normal_z=0.3, z_to_y_ratio=1.0,
                  base_z=2.0)
    gb2 = rasterize_billboards(gb, [b], env.uniforms())
    z = np.asarray(gb2.z)
    n = np.asarray(gb2.normal)
    # Covered texels: z = base + relY; normal = normalize(0, 1-|nz|, nz)
    # (AutoGBufferBitmap.fx:34-40).
    assert z[26, 24] > 2.0
    exp = np.asarray([0.0, 0.7, 0.3])
    exp /= np.linalg.norm(exp)
    np.testing.assert_allclose(n[26, 24], exp, atol=1e-5)
    # Alpha < 0.5 texels discard (untouched ground).
    assert z[40, 40] == 0.0
    assert z[17, 17] == 0.0  # transparent sprite corner


def test_auto_gbuffer_negative_normal_z_disables_occlusion():
    env, gb = _gb()
    tex = np.ones((4, 4, 4), np.float32)
    b = Billboard(screen_bounds=(8, 8, 16, 16), texture=tex,
                  type=TYPE_AUTO, normal_z=-999.0)
    gb2 = rasterize_billboards(gb, [b], env.uniforms())
    np.testing.assert_allclose(np.asarray(gb2.normal)[10, 10], 0.0)


def test_normal_billboard_reads_normal_map():
    env, gb = _gb()
    ntex = np.zeros((8, 8, 4), np.float32)
    ntex[..., :3] = [0.5, 0.5, 1.0]  # encoded +z
    ntex[..., 3] = 1.0
    b = Billboard(screen_bounds=(40, 40, 56, 56), texture=ntex,
                  type=TYPE_NORMAL_BILLBOARD, normals_are_signed=False)
    gb2 = rasterize_billboards(gb, [b], env.uniforms())
    np.testing.assert_allclose(np.asarray(gb2.normal)[48, 48],
                               [0.0, 0.0, 1.0], atol=1e-5)


def test_auto_gbuffer_z_from_distance_texture():
    env, gb = _gb()
    tex = np.ones((4, 4, 4), np.float32)
    dist = np.full((4, 4), 8.0, np.float32)
    b = Billboard(screen_bounds=(8, 8, 16, 16), texture=tex,
                  type=TYPE_AUTO, base_z=1.0, distance_texture=dist,
                  z_from_distance=(0.0, 5.0, 1.0))
    gb2 = rasterize_billboards(gb, [b], env.uniforms())
    # z = base + clamp(scale * 8, 0, 5) = 6.
    np.testing.assert_allclose(np.asarray(gb2.z)[10, 10], 6.0, atol=1e-5)
