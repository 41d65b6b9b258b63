"""Directional and line light families."""

import numpy as np

from illuminant.core.config import QualitySettings, RendererConfig
from illuminant.lighting.directional import (
    DirectionalLightSource,
    compute_directional_opacity,
    pack_directional_lights,
)
from illuminant.lighting.environment import (
    LightObstruction,
    LightingEnvironment,
    SphereLightSource,
)
from illuminant.lighting.line import (
    LineLightSource,
    closest_point_on_segment,
    compute_line_light_opacity,
    pack_line_lights,
)
from illuminant.lighting.renderer import LightingRenderer


def test_directional_opacity_oracle():
    # Straight-down light over an upward normal: d = dot(-dir, n) = 1 ->
    # saturate((1+0.35)/0.35)=1 -> 1^0.85 = 1.
    d = np.asarray([0.0, 0.0, -1.0, 1.0], np.float32)
    n = np.asarray([0.0, 0.0, 1.0], np.float32)
    assert float(compute_directional_opacity(d, n)) == 1.0
    # Grazing (perpendicular): d = 0 -> (0+0.35)/0.35 = 1 -> still 1
    # (the ramp is a mask, LightCommon.fxh:1-10).
    d2 = np.asarray([1.0, 0.0, 0.0, 1.0], np.float32)
    assert float(compute_directional_opacity(d2, n)) == 1.0
    # Behind the surface: dot = -1 -> 0.
    d3 = np.asarray([0.0, 0.0, 1.0, 1.0], np.float32)
    assert float(compute_directional_opacity(d3, n)) == 0.0
    # No direction (w < 0.1) -> ambient, always 1.
    d4 = np.asarray([0.0, 0.0, 1.0, 0.0], np.float32)
    assert float(compute_directional_opacity(d4, n)) == 1.0


def test_directional_light_shadows():
    env = LightingEnvironment(ambient=(0.0, 0.0, 0.0, 1.0))
    env.lights.append(
        DirectionalLightSource(
            direction=(1.0, 0.0, -0.5),
            color=(1.0, 1.0, 1.0, 1.0),
            shadow_trace_length=300.0,
        )
    )
    env.obstructions.append(
        LightObstruction.box((128.0, 128.0, 24.0), (10.0, 40.0, 24.0))
    )
    r = LightingRenderer(RendererConfig(width=256, height=256), env, None)
    r.update_fields()
    lm = np.asarray(r.render_lighting())
    open_region = lm[40, 40, :3].mean()
    shadow_region = lm[128, 160, :3].mean()  # east of the box
    assert open_region > 0.5, open_region
    assert shadow_region < open_region * 0.3, (open_region, shadow_region)


def test_closest_point_on_segment():
    p0 = np.zeros((3,), np.float32)
    p1 = np.asarray([10.0, 0.0, 0.0], np.float32)
    c, u = closest_point_on_segment(p0, p1, np.asarray([4.0, 3.0, 0.0]))
    np.testing.assert_allclose(np.asarray(c), [4.0, 0.0, 0.0], atol=1e-6)
    np.testing.assert_allclose(float(u), 0.4, atol=1e-6)
    c2, u2 = closest_point_on_segment(p0, p1, np.asarray([-5.0, 1.0, 0.0]))
    np.testing.assert_allclose(float(u2), 0.0)


def test_line_light_opacity_falls_off():
    p0 = np.asarray([0.0, 0.0, 10.0], np.float32)
    p1 = np.asarray([100.0, 0.0, 10.0], np.float32)
    n = np.asarray([0.0, 0.0, 1.0], np.float32)
    radius = np.float32(5.0)
    near, _, _ = compute_line_light_opacity(
        np.asarray([50.0, 10.0, 0.0], np.float32), n, p0, p1, radius
    )
    far, _, _ = compute_line_light_opacity(
        np.asarray([50.0, 120.0, 0.0], np.float32), n, p0, p1, radius
    )
    assert float(near) > float(far) > 0.0
    assert float(near) <= 1.0


def test_line_light_render_color_gradient():
    env = LightingEnvironment(ambient=(0.0, 0.0, 0.0, 1.0))
    env.lights.append(
        LineLightSource(
            start=(40.0, 128.0, 20.0),
            end=(216.0, 128.0, 20.0),
            radius=6.0,
            color_start=(1.0, 0.0, 0.0, 1.0),
            color_end=(0.0, 0.0, 1.0, 1.0),
            cast_shadows=False,
        )
    )
    r = LightingRenderer(RendererConfig(width=256, height=256), env, None)
    r.update_fields()
    lm = np.asarray(r.render_lighting())
    left = lm[100, 60]
    right = lm[100, 200]
    assert left[0] > left[2], "left end should be red-dominant"
    assert right[2] > right[0], "right end should be blue-dominant"


def test_volumetric_light_cone():
    from illuminant.lighting.volumetric import (
        SHAPE_CONE,
        VolumetricLightSource,
    )

    env = LightingEnvironment(ambient=(0.0, 0.0, 0.0, 1.0), maximum_z=64.0)
    env.lights.append(
        VolumetricLightSource(
            shape=SHAPE_CONE,
            start_position=(60.0, 128.0, 40.0),
            end_position=(200.0, 128.0, 10.0),
            start_radius=6.0,
            end_radius=30.0,
            volumetricity=0.3,
            color=(1.0, 0.9, 0.6, 1.0),
        )
    )
    r = LightingRenderer(RendererConfig(width=256, height=256), env, None)
    r.update_fields()
    lm = np.asarray(r.render_lighting())
    inside_beam = lm[128, 130, :3].mean()
    outside_beam = lm[30, 30, :3].mean()
    assert inside_beam > 0.05, inside_beam
    assert outside_beam < inside_beam * 0.1, (inside_beam, outside_beam)
    assert np.isfinite(lm).all()


def test_projector_light_projects_texture():
    from illuminant.lighting.projector import ProjectorLightSource

    tex = np.zeros((8, 8, 4), np.float32)
    tex[:, :4] = [1.0, 0.0, 0.0, 1.0]  # left half red
    tex[:, 4:] = [0.0, 1.0, 0.0, 1.0]  # right half green

    env = LightingEnvironment(ambient=(0.0, 0.0, 0.0, 1.0))
    env.lights.append(
        ProjectorLightSource(
            texture=tex,
            position=(64.0, 64.0, 0.0),
            scale=(64.0, 64.0),
            wrap=False,
        )
    )
    r = LightingRenderer(RendererConfig(width=192, height=192), env, None)
    r.update_fields()
    lm = np.asarray(r.render_lighting())
    left = lm[96, 70]  # inside projection, left half
    right = lm[96, 120]  # inside, right half
    outside = lm[20, 20]
    assert left[0] > 0.5 and left[1] < 0.1, left
    assert right[1] > 0.5 and right[0] < 0.1, right
    assert outside[:3].max() < 0.05, outside


def test_replicator_expands_to_sphere_lights():
    from illuminant.lighting.environment import (
        LightSourceReplicator,
        ReplicatedLight,
    )

    env = LightingEnvironment(ambient=(0.0, 0.0, 0.0, 1.0))
    rep = LightSourceReplicator(
        template=SphereLightSource(radius=6.0, ramp_length=80.0,
                                   color=(1.0, 1.0, 1.0, 1.0),
                                   cast_shadows=False)
    )
    rep.add(ReplicatedLight(position=(40.0, 64.0, 20.0)))
    rep.add(ReplicatedLight(position=(160.0, 64.0, 20.0),
                            color=(1.0, 0.0, 0.0, 1.0)))
    env.lights.append(rep)
    r = LightingRenderer(RendererConfig(width=192, height=128), env, None)
    r.update_fields()
    lm = np.asarray(r.render_lighting())
    assert lm[64, 40, :3].mean() > 0.3  # template light
    assert lm[64, 160, 0] > 0.3 and lm[64, 160, 1] < 0.05  # override red


def test_sphere_light_ramp_texture():
    # A red->blue 1D distance ramp recolors the falloff
    # (SphereLightWithDistanceRamp, SphereLightCore.fxh:99-119).
    ramp = np.zeros((1, 16, 3), np.float32)
    ramp[0, :, 0] = np.linspace(0.0, 1.0, 16)  # red rises with opacity
    ramp[0, :, 2] = np.linspace(1.0, 0.0, 16)  # blue falls
    env = LightingEnvironment(ambient=(0.0, 0.0, 0.0, 1.0))
    env.lights.append(
        SphereLightSource(
            position=(64.0, 64.0, 20.0), radius=6.0, ramp_length=100.0,
            color=(1.0, 1.0, 1.0, 1.0), cast_shadows=False,
            ramp_texture=ramp,
        )
    )
    r = LightingRenderer(RendererConfig(width=128, height=128), env, None)
    r.update_fields()
    lm = np.asarray(r.render_lighting())
    near = lm[64, 70]  # high opacity -> red end
    far = lm[110, 110]  # low opacity -> blue end
    assert near[0] > near[2], near
    assert far[2] > far[0], far


def test_projector_mixed_texture_sizes():
    """Mixed-size projector textures pad to the max dims; uv rescales by
    actual/padded so the smaller texture spans its full projection
    (review finding: it rendered squeezed into a corner with black
    padding sampled as content)."""
    import numpy as np
    import jax.numpy as jnp
    from illuminant.lighting.projector import (
        ProjectorLightSource, accumulate_projector_lights,
        pack_projector_lights)
    from illuminant.lighting import gbuffer as gbuf
    from illuminant.lighting.environment import LightingEnvironment
    from illuminant.core.config import QualitySettings
    from illuminant.sdf.analytic import pack_scene

    env = LightingEnvironment(ground_z=0.0, maximum_z=64.0)
    gb = gbuf.flat_ground(64, 96, env.uniforms())
    scene = pack_scene([])
    small = np.ones((8, 8, 4), np.float32)  # uniform white 8x8
    big = np.ones((32, 32, 4), np.float32)

    def render(textures):
        lights = pack_projector_lights([
            ProjectorLightSource(texture=t, position=(20.0, 10.0, 0.0),
                                 scale=(50.0, 40.0))
            for t in textures])
        return np.asarray(accumulate_projector_lights(
            scene, gb, lights, env.uniforms(), QualitySettings()))

    solo = render([small])
    mixed = render([small, big])  # small is padded to 32x32 here
    # The small light's contribution must be identical whether or not a
    # bigger texture forced padding (uniform textures -> the projected
    # quad [20,70]x[10,50] fully lit in both).
    quad = solo[15:45, 25:65]
    assert quad.min() > 0.1, quad.min()
    # mixed = small + big contributions; both uniform white on the same
    # quad, so mixed == 2 * solo there.
    np.testing.assert_allclose(mixed[15:45, 25:65],
                               2.0 * solo[15:45, 25:65], atol=1e-3)


def test_projector_singular_matrix_degrades():
    import numpy as np
    from illuminant.lighting.projector import (
        ProjectorLightSource, pack_projector_lights)

    lights = pack_projector_lights([
        ProjectorLightSource(texture=np.ones((4, 4, 4), np.float32),
                             scale=(0.0, 10.0))])  # singular transform
    assert lights is not None  # no LinAlgError
