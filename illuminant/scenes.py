"""Benchmark / flagship scene builders.

The flagship scene is the FULL BASELINE.md config-5 workload ("full
Lumined scene"), all advanced by ONE jitted frame function:

  * 8 sphere lights, cone-traced soft shadows (scan path at the library
    default quality: shadow_scale 0.5, scan_refine_samples 1 — measured
    march-equivalent to 2, tests/test_refine_quality.py);
  * DYNAMIC SDF occluders — two of the four obstructions move every
    frame. The analytic field (sdf/analytic.py) re-evaluates exactly each
    frame, which subsumes the reference's budgeted slice re-rasterization
    (LightingRenderer.DistanceField.cs) with zero staleness;
  * a 1M-particle system: bezier-path-animated spawner, gravity, SDF
    collision against the MOVING occluders;
  * BEZIER-ANIMATED parameters (Bezier.fxh semantics): light radius
    pulse, spawner emission point path, per-particle size/color-from-life
    ramps;
  * full-resolution tiled particle rasterization (raster/tiled.py);
  * HDR luminance histogram (utils/histogram.py, 64 log buckets, full
    resolution) driving auto-exposure from the PREVIOUS frame (the
    reference reads the previous frame's luminance ring buffer,
    LightingRenderer.HDR.cs:21-55);
  * Uncharted2 tonemap resolve (Resolve.fx:124-133) to a uint8 frame.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from .core.config import QualitySettings, RendererConfig
from .lighting import gbuffer as gbuf
from .lighting.environment import (
    LightObstruction,
    LightingEnvironment,
    SphereLightSource,
    pack_sphere_lights,
)
from .lighting.sphere import accumulate_sphere_lights
from .ops import tonemap as tm
from .ops.bezier import (
    DynamicMatrix,
    constant_bezier,
    evaluate_bezier,
    evaluate_bezier_matrix,
    pack_bezier,
    pack_bezier_matrix,
)
from .particles.formula import FORMULA_SPHERICAL, Formula1, Formula3, Formula4
from .particles.integrate import integrate_with_distance_field
from .particles.render_data import RenderDataUniforms
from .particles.spawner import Spawner, spawn as spawn_fn
from .particles.state import ParticleState
from .particles.system import ParticleSystem, ParticleSystemConfig
from .particles import transforms as tx
from .raster.tiled import TiledRasterConfig, rasterize_tiled
from .sdf import analytic, volume as vol
from .utils.histogram import bucket_boundaries, compute_histogram, percentile


# The five benched variants of the flagship frame: build_flagship keyword
# arguments by row name (bench.py, chip_smoke.py).
FLAGSHIP_VARIANTS = {
    "fast": dict(preset="fast"),
    "parity": dict(preset="parity"),
    "full_family": dict(preset="fast", full_family=True),
    "parity_full_family": dict(preset="parity", full_family=True),
    "voxel": dict(preset="fast", field="voxel"),
}


@dataclasses.dataclass
class FlagshipScene:
    config: RendererConfig
    environment: LightingEnvironment
    # Voxel-field config for callers that want a baked SdfVolume of the
    # same scene (tests); the FRAME renders from the analytic
    # field and never reads this.
    sdf_config: vol.SdfVolumeConfig
    volume: object  # AnalyticScene (JAX-native) or SdfVolume
    gbuffer: object
    sphere_lights: object
    system: ParticleSystem
    raster_config: TiledRasterConfig
    # jitted (state, avg_lum, key, volume, gbuffer, lights, env_u,
    # spawn_count[, frame_index]) -> (img, state, avg_lum, dropped);
    # frame_index drives the per-frame dynamics (occluder orbit, light
    # orbit/pulse, spawn path, RNG fold) and defaults to 0.
    frame: object
    frame_loop: object  # jitted n-frames-per-dispatch variant
    spawner: Spawner
    # Packed extra-family lights (the full_family dict: directional /
    # line / volumetric / projector / particle_light + support radii),
    # None for sphere-only scenes. Tools/tests attribution hook.
    extra_lights: Optional[dict] = None


def build_flagship(
    height: int = 1080,
    width: int = 1920,
    n_lights: int = 8,
    capacity: int = 1 << 20,
    spawn_max: int = 4096,
    sdf_resolution_scale: float = 0.25,
    quality: Optional[QualitySettings] = None,
    bin_capacity: int = 1016,
    preset: str = "fast",
    shadow_mode: str = "scan",
    full_family: bool = False,
    spawn_sub_rings: int = 1,
    collision_substeps: Optional[int] = None,
    raster_preset: Optional[str] = None,
    mesh=None,
    field: str = "analytic",
) -> FlagshipScene:
    """The full config-5 frame: see module docstring.

    `preset` picks the benched quality point:
      * "fast" — the library-default quality knobs (shadow_scale 0.5,
        scan_refine_samples 1, collision substeps 1, Gaussian glow
        kernel, compact rgb888 payload). Every knob's deviation from the
        reference is individually measured (PERF.md "Deliberate
        approximations").
    `mesh` (optional jax.sharding.Mesh): build the frame for MULTI-CHIP
    execution — the scan passes trace under scan_shadows.spmd_mesh so
    their sequential nomination walks pin replicated and the per-pixel
    refine/readout pins row-sharded (the collective-storm fix, see
    scan_shadows.spmd_mesh). Callers shard the frame inputs with
    parallel.mesh helpers; a mesh-built frame fed single-device inputs
    would still distribute over the mesh, so build WITHOUT mesh for
    single-chip runs.

      * "parity" — reference-parity semantics: 3 collision substeps
        (UpdateParticleSystemWithDistanceField.fx:29-147), full-res
        shadow readout with ONE refine sample (the recorded A/B vs the
        ConeTrace.fxh march bounds the second sample's effect at
        < 0.006 mean |error| — see the QualitySettings comment below),
        the round disc kernel (computeCircularAlpha, fx:145-156), and
        the full-precision payload (1/16-px positions + bf16 colors).
    """
    if preset not in ("fast", "parity"):
        raise ValueError(f"unknown preset {preset!r}")
    if field not in ("analytic", "voxel"):
        raise ValueError(f"unknown field {field!r}")
    if raster_preset not in (None, "fast", "parity"):
        raise ValueError(f"unknown raster_preset {raster_preset!r}")
    _FAMILIES = {"directional", "line", "volumetric", "projector",
                 "particle"}
    if not isinstance(full_family, bool):
        bad = set(full_family) - _FAMILIES
        if bad:
            raise ValueError(f"unknown light families {sorted(bad)}; "
                             f"valid: {sorted(_FAMILIES)}")
    parity = preset == "parity"
    substeps = (collision_substeps if collision_substeps is not None
                else (3 if parity else 1))
    if quality is None and parity:
        # refine=1, not 2: the recorded A/B (tests/test_refine_quality.py,
        # native-res scan vs the exact march over tall/short/mixed scenes)
        # shows the second refine sample changes mean |error| by < 0.006 —
        # while at full res each sample is an 8-light x 2-Mpixel analytic
        # scene eval.
        quality = QualitySettings(shadow_scale=1.0, scan_refine_samples=1,
                                  # Quarter-res blocker NOMINATION under
                                  # the full-res refine/cone readout:
                                  # every shadow pixel still gets its own
                                  # 3D scene evaluation and cone radius;
                                  # only the walk that PICKS the blocker
                                  # is coarse. Error vs the exact march
                                  # measured AT the full-res walk's level
                                  # on all three scene classes at the
                                  # same grid/nomination ratio
                                  # (test_refine_quality.py); the walk is
                                  # the dominant full-res scan cost.
                                  scan_nomination_scale=0.25,
                                  # Parity shades every family at
                                  # lightmap resolution, like the
                                  # reference's one light pass over all
                                  # families (LightingRenderer.cs:
                                  # 1004-1168).
                                  extra_family_scale=1.0)
    env = LightingEnvironment(
        ground_z=0.0, maximum_z=128.0, ambient=(0.03, 0.03, 0.04, 1.0)
    )
    cx, cy = width * 0.5, height * 0.5
    ring = min(width, height) * 0.38
    colors = [
        (1.0, 0.5, 0.3, 1.0), (0.3, 1.0, 0.5, 1.0), (0.4, 0.5, 1.0, 1.0),
        (1.0, 0.9, 0.4, 1.0), (0.9, 0.3, 0.9, 1.0), (0.3, 0.9, 0.9, 1.0),
        (1.0, 0.7, 0.7, 1.0), (0.7, 1.0, 0.7, 1.0),
    ]
    for i in range(n_lights):
        a = 2 * math.pi * i / n_lights
        env.lights.append(
            SphereLightSource(
                position=(cx + ring * math.cos(a), cy + ring * math.sin(a),
                          40.0),
                radius=12.0,
                ramp_length=max(width, height) * 0.45,
                color=colors[i % len(colors)],
            )
        )
    # Occluders. Two are DYNAMIC (device-side animation below).
    env.obstructions += [
        LightObstruction.box((cx, cy, 24.0), (22.0, 22.0, 24.0)),
        LightObstruction.ellipsoid((cx - ring * 0.5, cy, 20.0),
                                   (28.0, 16.0, 20.0), is_dynamic=True),
        LightObstruction.cylinder((cx, cy - ring * 0.5, 26.0),
                                  (12.0, 12.0, 26.0), is_dynamic=True),
        LightObstruction.box((cx + ring * 0.45, cy + ring * 0.3, 16.0),
                             (30.0, 10.0, 16.0)),
    ]

    config = RendererConfig(
        width=width, height=height,
        # Library-default quality: shadow_scale 0.5, scan_refine_samples 1.
        quality=quality or QualitySettings(),
    )
    sdf_config = vol.SdfVolumeConfig(
        virtual_width=width,
        virtual_height=height,
        virtual_depth=64,
        slice_count=16,
        resolution_scale=sdf_resolution_scale,
    )
    # The analytic scene is the JAX-native field (sdf/analytic.py): exact
    # per-frame dynamics, no voxel staleness, no gathers. Tight group
    # packing (round=1): the scene is fixed, so jit-cache padding buys
    # nothing and every eval slot costs real flops in 4 distance passes
    # per frame (integrator) + the occlusion image + refine samples.
    volume = analytic.pack_scene(env.obstructions, group_capacity_round=1)
    # `volume` stays the analytic pack (animation frequency mapping needs
    # its group order); `scene_field` is what the FRAME actually queries.
    voxel_static = None
    voxel_dyn_obs = None
    if field == "voxel":
        # The reference's PRODUCTION field is the voxel atlas
        # (SDF/DistanceField.cs:18-22): bake the STATIC partition, Save
        # then Load it (the shipped-Lumined-scene path, Save/Load
        # :178-213) and regenerate the small DYNAMIC partition per frame
        # (DynamicDistanceField, :248-321 — a moving obstruction
        # invalidates its whole z-range every frame, so the budgeted
        # re-raster degenerates to a full dynamic regen here).
        import os as _os
        import tempfile as _tempfile

        static_vox = vol.generate_volume(
            sdf_config, env.pack_obstructions(dynamic=False))
        path = _os.path.join(
            _tempfile.gettempdir(),
            f"illum_flagship_field_{width}x{height}_"
            f"{sdf_resolution_scale}.npz")
        vol.save(static_vox, path)
        voxel_static = vol.load(path)
        voxel_dyn_obs = env.pack_obstructions(dynamic=True)
    env_u = env.uniforms()
    gbuffer = gbuf.flat_ground(height, width, env_u)
    sphere_lights = pack_sphere_lights(
        [l for l in env.lights if isinstance(l, SphereLightSource)],
        capacity=max(n_lights, 1),
    )

    # Full "Lumined scene" light set (BASELINE config 5's words; the
    # reference light pass iterates every family in one batch group,
    # LightingRenderer.cs:1004-1168): directional sun, line light,
    # shadowed volumetric, projector, particle lights.
    extra = None
    # full_family: False | True (all) | iterable of family names from
    # {"directional", "line", "volumetric", "projector", "particle"} —
    # subsets exist for cost attribution.
    fam_set = (
        {"directional", "line", "volumetric", "projector", "particle"}
        if full_family is True
        else (set(full_family) if full_family else set())
    )
    if fam_set:
        from .lighting.directional import (
            DirectionalLightSource, pack_directional_lights)
        from .lighting.line import LineLightSource, pack_line_lights
        from .lighting.volumetric import (
            SHAPE_ELLIPSOID, VolumetricLightSource, pack_volumetric_lights)
        from .lighting.projector import (
            ProjectorLightSource, pack_projector_lights)
        from .lighting.particle_light import ParticleLightSource

        sun = DirectionalLightSource(
            direction=(0.35, 0.55, -0.76),
            color=(0.35, 0.33, 0.28, 1.0),
            shadow_trace_length=256.0,
            shadow_softness=12.0, shadow_ramp_rate=0.5,
        )
        line = LineLightSource(
            start=(cx - ring * 0.9, cy - ring * 0.75, 44.0),
            end=(cx + ring * 0.9, cy - ring * 0.75, 44.0),
            radius=6.0,
            color_start=(0.9, 0.2, 0.2, 0.9),
            color_end=(0.2, 0.3, 0.9, 0.9),
        )
        # Ellipsoid semantics (LightSource.cs:381-383): end_position IS
        # the radius vector for ellipsoids/boxes (round 3 authored it as
        # a far endpoint — a screen-sized pancake the fixed window
        # silently truncated; the derived-window path below would have
        # flagged it).
        volum = VolumetricLightSource(
            shape=SHAPE_ELLIPSOID,
            start_position=(cx - ring * 0.6, cy + ring * 0.55, 30.0),
            end_position=(110.0, 80.0, 26.0),
            volumetricity=0.75, distance_attenuation=0.8,
            # Soft silhouette: the default ramp_length (1 world unit) is
            # a hard edge — sub-pixel detail no resolution lever can
            # represent (and the half-res extra-family path visibly
            # aliased it). 24 units matches the scene's soft look and
            # keeps the lever's error band-limited (test_advice_r4.py).
            ramp_length=24.0,
            color=(0.5, 0.8, 0.6, 0.8),
            cast_shadows=True,
        )
        # Procedural projected texture (a soft window-pane pattern).
        ty, txx = np.meshgrid(np.linspace(0, 1, 64), np.linspace(0, 1, 64),
                              indexing="ij")
        pane = (np.sin(txx * np.pi * 4) * np.sin(ty * np.pi * 4)) ** 2
        ptex = np.stack([pane * 0.9, pane * 0.8, pane * 0.5,
                         np.ones_like(pane)], axis=-1).astype(np.float32)
        proj = ProjectorLightSource(
            texture=ptex,
            position=(cx + ring * 0.35, cy + ring * 0.4, 0.0),
            scale=(260.0, 200.0),
            opacity=0.8,
        )
        plight = ParticleLightSource(
            template=SphereLightSource(
                position=(0.0, 0.0, 0.0), radius=3.0,
                ramp_length=90.0, color=(1.0, 1.0, 1.0, 0.035),
                # Shadowless template (the common reference usage —
                # ParticleLights.cs demo tweaks this; 32 extra shadow
                # traces would dominate the frame).
                cast_shadows=False,
            ),
            max_lights=32,
        )
        extra = {}
        if "directional" in fam_set:
            extra["directional"] = pack_directional_lights([sun])
            # Host-side AO gate (directional.py:223-224): with radius 0
            # the AO term is identically 1 but still costs a full-res
            # field evaluation per light unless statically skipped.
            extra["directional_ao"] = bool(np.any(np.asarray(
                extra["directional"].more[:, 0]) > 0.0))
        if "line" in fam_set:
            extra["line"] = pack_line_lights([line])
            extra["line_ao"] = bool(np.any(np.asarray(
                extra["line"].more[:, 0]) > 0.0))
        if "volumetric" in fam_set:
            from .lighting.volumetric import (
                support_radius_px as vol_support_px)

            extra["volumetric"] = pack_volumetric_lights([volum])
            # World-unit support radius (scaled per evaluation buffer
            # below) — derives each window from the light's actual
            # bounds, like the reference's per-light quads
            # (LightingRenderer.cs:1193-1446).
            extra["volumetric_support"] = float(np.max(np.asarray(
                vol_support_px(extra["volumetric"]))))
        if "projector" in fam_set:
            from .lighting.projector import (
                support_radius_px as proj_support_px)

            extra["projector"] = pack_projector_lights([proj])
            # Projected-quad centers for the windowed evaluation.
            extra["projector_centers"] = jnp.asarray(
                [[proj.position[0] + proj.scale[0] * 0.5,
                  proj.position[1] + proj.scale[1] * 0.5]], jnp.float32)
            extra["projector_support"] = float(np.max(
                proj_support_px([proj])))
        if "particle" in fam_set:
            extra["particle_light"] = plight

    # Dynamic-occluder animation amplitudes per analytic group, aligned
    # with pack_scene's type-sorted group order. The ellipsoid orbits a
    # small circle; both dynamic occluders orbit the same (60, 40) ellipse at group-indexed frequencies.
    anim_amp = []
    anim_freq = []
    for gi, type_id in enumerate(volume.group_types):
        n = volume.centers[gi].shape[0]
        amp = np.zeros((n, 3), np.float32)
        freq = np.zeros((n,), np.float32)
        for j, o in enumerate(
            [o for o in env.obstructions if o.type == type_id][:n]
        ):
            if o.is_dynamic:
                amp[j] = (60.0, 40.0, 0.0)
                freq[j] = 0.9 + 0.3 * gi
        anim_amp.append(jnp.asarray(amp))
        anim_freq.append(jnp.asarray(freq))
    anim_amp = tuple(anim_amp)
    anim_freq = tuple(anim_freq)

    def animate_volume(volume_, t):
        """Move dynamic occluders (the analytic equivalent of the dynamic
        partition re-rasterizing every frame)."""
        new_centers = tuple(
            c + a * jnp.stack(
                [jnp.sin(f * t), jnp.cos(f * t), jnp.zeros_like(f)],
                axis=-1,
            )
            for c, a, f in zip(volume_.centers, anim_amp, anim_freq)
        )
        return volume_.replace(centers=new_centers)

    if field == "voxel":
        # Same orbit constants keyed to the same analytic group
        # frequencies, applied to the packed dynamic partition; the
        # dynamic slab regenerates dense each frame and min-combines
        # with the loaded static field (DistanceField.cs:248-321).
        _dyn_list = [o for o in env.obstructions if o.is_dynamic]
        _damp = np.zeros((voxel_dyn_obs.centers.shape[0], 3), np.float32)
        _dfreq = np.zeros((voxel_dyn_obs.centers.shape[0],), np.float32)
        for _j, _o in enumerate(_dyn_list):
            _damp[_j] = (60.0, 40.0, 0.0)
            _dfreq[_j] = 0.9 + 0.3 * volume.group_types.index(_o.type)
        _damp = jnp.asarray(_damp)
        _dfreq = jnp.asarray(_dfreq)

        def animate_volume(volume_, t):  # noqa: F811
            from .sdf.columns import build_column_maps

            centers = voxel_dyn_obs.centers + _damp * jnp.stack(
                [jnp.sin(_dfreq * t), jnp.cos(_dfreq * t),
                 jnp.zeros_like(_dfreq)], axis=-1)
            dyn_vol = vol.generate_volume(
                sdf_config, voxel_dyn_obs.replace(centers=centers))
            combined = vol.combine_static_dynamic(volume_, dyn_vol)
            # Barrier: the frame samples this volume from several stages
            # (collision, occlusion image, refine, AO); without it XLA
            # rematerializes the whole regen+combine into each consumer.
            combined = combined.replace(
                data=jax.lax.optimization_barrier(combined.data))
            # Column-interval maps (sdf/columns.py): scattered consumers
            # (collision, refine) read the 2D maps — 16x fewer MACs than
            # the 3D contraction; grid consumers (occlusion stack) stay
            # exact on the combined volume. Rebuilt per frame after the
            # dynamic regen; barriered for the same reason as the data.
            cf = build_column_maps(combined)
            f, ht, hb, mc = jax.lax.optimization_barrier(
                (cf.flat_d, cf.h_top, cf.h_bot, cf.maps_c))
            return cf.replace(flat_d=f, h_top=ht, h_bot=hb, maps_c=mc)

    # Particle system: bezier-animated spawner + gravity + SDF collision.
    p_config = ParticleSystemConfig(
        capacity=capacity,
        updates_per_second=0.0,
        life_decay_per_second=0.2,
        friction=0.05,
        maximum_velocity=600.0,
        collision_distance=1.0,
        bounce_velocity_multiplier=0.7,
    )
    # Tangential orbit spawn — the reference's own recipe: shared
    # position/velocity randomness (AlignVelocityAndPosition,
    # SpawnerCommon.fxh:114-117) makes the velocity RADIAL, and a 90-deg
    # velocity post-matrix (Parameter<DynamicMatrix> VelocityPostMatrix)
    # turns it TANGENTIAL, so particles orbit the attractor instead of
    # collapsing into it (keeps raster tile occupancy honest and even).
    # The 90-deg turn is ANIMATED: a Parameter<DynamicMatrix> bezier
    # wobbles the rotation 75->105 deg over 4 s (ParticleSpawner.cs
    # VelocityPostMatrix is Parameter<DynamicMatrix>, re-evaluated per
    # frame; BezierM angle interpolation, Bezier.cs:379-424), so the
    # orbit injection angle breathes.
    # Wobble width is occupancy-bounded: below ~84 deg the injection
    # spirals inward enough to overflow hot raster tiles (measured ~3k
    # drops/frame at 75 deg; 0 at 84).
    rot90 = pack_bezier_matrix(
        [DynamicMatrix.from_components(angle=84.0),
         DynamicMatrix.from_components(angle=96.0),
         DynamicMatrix.from_components(angle=84.0)],
        min_value=0.0, max_value=4.0,
    )
    spawner = Spawner(
        min_rate=float(capacity) * 0.2,  # refill ~20%/s
        max_rate=float(capacity) * 0.2,
        life=Formula1(constant=2.5, random_scale=1.0, offset=-0.5),
        position=Formula3(constant=(cx, cy, 30.0),
                          offset=(width * 0.36, height * 0.37, 8.0),
                          random_scale=(width * 0.14, height * 0.13, 4.0),
                          type=FORMULA_SPHERICAL),
        velocity=Formula3(offset=(150.0, 150.0, 0.0),
                          random_scale=(40.0, 40.0, 10.0),
                          type=FORMULA_SPHERICAL),
        align_velocity_and_position=True,
        velocity_post_matrix=rot90,
        color=Formula4(constant=(0.4, 0.5, 0.9, 0.5),
                       random_scale=(0.4, 0.3, 0.1, 0.3)),
        spawn_max=spawn_max,
    )
    # Attractor + central repulsor: the pair forms a stable annulus —
    # particles orbit between the repulsor's push and the attractor's
    # pull, spreading density across the screen instead of piling into
    # the core (keeps per-tile raster occupancy bounded). Both are plain
    # reference Gravity attractors (negative strength = repulsion).
    grav = tx.Gravity(attractors=[
        tx.Attractor(position=(cx, cy, 20.0),
                     radius=float(max(width, height)),
                     strength=32.0, falloff_type=tx.FALLOFF_LINEAR),
        tx.Attractor(position=(cx, cy, 20.0), radius=float(height) * 0.38,
                     strength=-110.0, falloff_type=tx.FALLOFF_LINEAR),
    ], maximum_acceleration=3000.0)
    # Per-particle bezier ramps (ParticleSystemConfiguration.SizeFromLife /
    # ColorFromLife, ParticleConfiguration.cs:187-210): size shrinks and
    # color fades as life runs out.
    render_data = RenderDataUniforms(
        color_from_life=pack_bezier(
            [(0.3, 0.3, 0.6, 0.0), (1.0, 1.0, 1.0, 1.0),
             (1.0, 1.0, 1.0, 1.0)],
            min_value=0.0, max_value=4.0,
        ),
        color_from_velocity=constant_bezier([1.0, 1.0, 1.0, 1.0]),
        size_from_life=pack_bezier([[1.0], [2.5], [3.0]],
                                   min_value=0.0, max_value=4.0),
        size_from_velocity=constant_bezier([1.0]),
        rotation_from_life_and_index=jnp.zeros((2,), jnp.float32),
        velocity_rotation=jnp.asarray(0.0, jnp.float32),
    )
    system = ParticleSystem(p_config, [spawner, grav], volume=volume,
                            render_data=render_data)

    dt = 1.0 / 60.0  # one timestep for physics AND animation time
    su = system.system_uniforms(dt)
    rd = system.render_data
    grav_u = grav.uniforms(0.0)
    spawn_u = spawner.uniforms(0.0)

    # Bezier-animated scene parameters (Parameter<T>-over-Bezier,
    # Modeling layer): light radius pulse + spawner emission path.
    light_radius_bezier = pack_bezier([[10.0], [16.0], [11.0], [10.0]],
                                      min_value=0.0, max_value=2.0)
    # NOTE: an OPEN cubic under the mod-6 time wrap — the emission point
    # jumps from P3 back to P0 every 6 s. Harmless for the benchmark
    # (cost-identical, and the tuned occupancy/drop balance depends on
    # this exact path); close the loop (repeat P0) if reusing the scene
    # where the pop would show.
    spawn_path_bezier = pack_bezier(
        [(cx - ring * 0.5, cy, 30.0), (cx, cy - ring * 0.4, 34.0),
         (cx + ring * 0.5, cy, 30.0), (cx, cy + ring * 0.4, 26.0)],
        min_value=0.0, max_value=6.0,
    )

    if (raster_preset or preset) == "parity":
        raster_config = TiledRasterConfig(
            height=height, width=width, tile=32,
            bin_capacity=bin_capacity, apron=4, kernel="round",
            rgba8_colors=False, channels=3, slots_per_row=16,
            compact_payload=False,
        )
    else:
        raster_config = TiledRasterConfig(
            height=height, width=width, tile=32,
            bin_capacity=bin_capacity, apron=4, kernel="gauss",
            rgba8_colors=True, color_scale=4.0, channels=3,
            slots_per_row=16, compact_payload=True, int8_splat=True,
        )
    hist_bounds = jnp.asarray(bucket_boundaries(max_value=64.0))

    def _frame_body(i, state, avg_lum, key, volume_, gbuffer_, lights_,
                    env_u_, spawn_count):
        from .lighting.scan_shadows import spmd_mesh as _spmd_scope

        with _spmd_scope(mesh):
            return _frame_body_inner(i, state, avg_lum, key, volume_,
                                     gbuffer_, lights_, env_u_,
                                     spawn_count)

    def _frame_body_inner(i, state, avg_lum, key, volume_, gbuffer_,
                          lights_, env_u_, spawn_count):
        t = i.astype(jnp.float32) * dt

        # -- dynamic occluders (device-side) --
        vol_t = animate_volume(volume_, t)

        # -- bezier-animated light parameters + orbit --
        ang = i.astype(jnp.float32) * 0.01
        ca, sa = jnp.cos(ang), jnp.sin(ang)
        center = jnp.asarray([cx, cy, 0.0], jnp.float32)
        rel = lights_.position - center
        rot = jnp.stack(
            [rel[:, 0] * ca - rel[:, 1] * sa,
             rel[:, 0] * sa + rel[:, 1] * ca,
             rel[:, 2]],
            axis=-1,
        )
        radius_t = evaluate_bezier(
            light_radius_bezier, jnp.mod(t, 2.0)
        )[0]
        props = lights_.properties.at[:, 0].set(radius_t)
        lights_i = lights_.replace(position=center + rot, properties=props)

        # -- lighting --
        lightmap = jnp.broadcast_to(
            env_u_.ambient[:3],
            (gbuffer_.z.shape[0], gbuffer_.z.shape[1], 3),
        ).astype(jnp.float32)

        sphere_vis = None
        line_vis = None
        dir_vis = None
        fuse_line = extra is not None and "line" in extra
        fuse_dir = extra is not None and "directional" in extra
        if (fuse_line or fuse_dir) and shadow_mode == "scan":
            # FUSED multi-family radial scan: the line light's 3 anchors
            # and the directional sun's far pseudo-center ride the
            # sphere lights' scan pass as extra lanes on the L axis (the
            # scan's sequential column walk is per-PASS, so a few more
            # lights are nearly free) — one scan pass instead of three, and the extra
            # families' shadows land at the sphere pass's scan
            # resolution instead of the quarter-res extra-family
            # buffer's. (Standalone, the directional MARCH beat the
            # directional scan for few-primitive scenes, but fused, the
            # sun's marginal scan cost is one lane + one refine eval.)
            # The directional pseudo-center sits thousands of
            # units out, so the shared trace plane must be pinned to the
            # radial lights' height (over-nomination is safe for the
            # sun: its 3D refine rejects blockers the climbing ray
            # clears; under-nomination — a plane above the occluder
            # tops — would erase its shadows).
            from .lighting.scan_shadows import scan_cone_visibility

            ns = lights_i.position.shape[0]
            pos_parts = [lights_i.position]
            rad_parts = [lights_i.properties[:, 0]]
            ramp_parts = [lights_i.properties[:, 1]]
            # Per-family self-occlusion lifts: SphereLightCore.fxh:151
            # (1.6) vs LineLightCore.fxh:10 / DirectionalLight.fx:13
            # (1.5).
            lift_parts = [jnp.full((ns,), 1.6, jnp.float32)]
            # Spheres trace to the light (no cap): a cap beyond any
            # screen diagonal is a no-op in the readout.
            mtd_parts = [jnp.full((ns,), 1e8, jnp.float32)]
            nd = 0
            if fuse_dir:
                from .lighting.directional import directional_scan_args

                (dcen, drad, dramp, dtrace, _dplane) = (
                    directional_scan_args(
                        gbuffer_, extra["directional"], env_u_))
                nd = dcen.shape[0]
                pos_parts.append(dcen)
                rad_parts.append(drad)
                ramp_parts.append(dramp)
                lift_parts.append(jnp.full((nd,), 1.5, jnp.float32))
                mtd_parts.append(dtrace)
            if fuse_line:
                from .lighting.line import line_scan_anchors

                anchors, rad3, ramp3 = line_scan_anchors(extra["line"])
                pos_parts.append(anchors)
                rad_parts.append(rad3)
                ramp_parts.append(ramp3)
                lift_parts.append(
                    jnp.full((rad3.shape[0],), 1.5, jnp.float32))
                mtd_parts.append(
                    jnp.full((rad3.shape[0],), 1e8, jnp.float32))
            vis_all = scan_cone_visibility(
                vol_t, gbuffer_,
                jnp.concatenate(pos_parts, 0),
                jnp.concatenate(rad_parts),
                jnp.concatenate(ramp_parts),
                config.quality,
                self_occlusion_lift=jnp.concatenate(lift_parts),
                max_trace_distance=jnp.concatenate(mtd_parts),
                # Active-masked trace plane (pad slots sit at z=0 and
                # would drag it toward the floor).
                trace_z=jnp.sum(
                    lights_i.position[:, 2] * lights_i.active
                ) / jnp.maximum(jnp.sum(lights_i.active), 1.0) * 0.4,
                upsample=False,
            )
            from .lighting.scan_shadows import resize_visibility

            sphere_vis = resize_visibility(vis_all[:ns], gbuffer_.shape)
            dir_vis = vis_all[ns:ns + nd] if fuse_dir else None
            line_vis = vis_all[ns + nd:] if fuse_line else None

        lightmap = lightmap + accumulate_sphere_lights(
            vol_t, gbuffer_, lights_i, env_u_, config.quality,
            with_specular=False, shadow_mode=shadow_mode, with_ao=False,
            with_alpha=False, scan_visibility_precomputed=sphere_vis,
        )
        if extra is not None:
            from .lighting.directional import accumulate_directional_lights
            from .lighting.line import accumulate_line_lights
            from .lighting.volumetric import accumulate_volumetric_lights
            from .lighting.projector import accumulate_projector_lights
            from .lighting.particle_light import accumulate_particle_lights
            from .lighting.scan_shadows import upsample2x_bilinear
            from .lighting.windowed import (
                accumulate_windowed, window_for_support)

            def take_light(tree, i):
                return jax.tree.map(lambda a: a[i:i + 1], tree)

            # The EXTRA families evaluate at quality.extra_family_scale
            # resolution (default 0.5) and upsample together: the
            # sun/line/volumetric/particle-light terms are band-limited
            # on this flat scene, and the per-light resolution knob is
            # the reference's own lever (LightSource.Quality +
            # RendererConfiguration.RenderScale). Half res quarters the
            # (L, H, W) falloff/shadow chains. Half-vs-full
            # accumulation error is pinned by tests/test_advice_r4.py.
            # The projector keeps full res (projected texture detail).
            # The parity preset runs every family at lightmap res
            # (LightingRenderer.cs:1004-1168).
            h_, w_ = gbuffer_.shape
            half_ok = (config.quality.extra_family_scale == 0.5
                       and h_ % 2 == 0 and w_ % 2 == 0)
            if half_ok:
                gb_ex = gbuf.flat_ground(
                    h_ // 2, w_ // 2, env_u_,
                    render_scale=0.5 * gbuffer_.render_scale,
                )
            else:
                gb_ex = gbuffer_
            ex = jnp.zeros(gb_ex.shape + (3,), jnp.float32)
            if "directional" in extra:
                dv = dir_vis
                if dv is not None:
                    dv = resize_visibility(dv, gb_ex.shape)
                ex = ex + accumulate_directional_lights(
                    vol_t, gb_ex, extra["directional"], env_u_,
                    config.quality,
                    # Fused-scan visibility when the sphere pass runs
                    # the scan; the standalone march otherwise (faster
                    # than a standalone scan for few-primitive scenes).
                    shadow_mode="march" if dv is None else "scan",
                    scan_visibility_precomputed=dv,
                    with_ao=extra.get("directional_ao", True),
                )[..., :3]
            if "line" in extra:
                lv = line_vis
                if lv is not None:
                    lv = resize_visibility(lv, gb_ex.shape)
                ex = ex + accumulate_line_lights(
                    vol_t, gb_ex, extra["line"], env_u_,
                    config.quality, shadow_mode="scan",
                    scan_visibility_precomputed=lv,
                    with_ao=extra.get("line_ao", True),
                )[..., :3]
            # Volumetric lights are spatially BOUNDED: each window is
            # DERIVED from the light's support radius (lighting/
            # windowed.py:window_for_support — the array analog of the
            # reference sizing each instanced quad from its light's
            # bounds, LightingRenderer.cs:1193-1446), so nothing is
            # silently truncated. Static centers -> static window
            # origins -> shard-safe static slices (windowed.py note).
            if "volumetric" in extra:
                vl = extra["volumetric"]
                win = window_for_support(
                    extra["volumetric_support"] * gb_ex.render_scale,
                    *gb_ex.shape)
                ex = accumulate_windowed(
                    ex, gb_ex,
                    vl.start[:, :2] * gb_ex.render_scale, win,
                    lambda i, gbw: accumulate_volumetric_lights(
                        vol_t, gbw, take_light(vl, i), env_u_,
                        config.quality, shadowed=True,
                        shadow_detail="scan",
                    ),
                )
            # Particle lights read the INCOMING state — the reference's
            # usePreviousData convention (LightingRenderer.cs:1138-43).
            if "particle_light" in extra:
                ex = ex + accumulate_particle_lights(
                    vol_t, gb_ex, state, extra["particle_light"],
                    env_u_, config.quality, shadow_mode="scan",
                )[..., :3]
            if half_ok:
                up = upsample2x_bilinear(
                    jnp.moveaxis(ex, -1, 0).astype(jnp.bfloat16)
                )
                lightmap = lightmap + jnp.moveaxis(up, 0, -1).astype(
                    jnp.float32)
            else:
                lightmap = lightmap + ex
            if "projector" in extra:
                pj = extra["projector"]
                win_p = window_for_support(
                    extra["projector_support"] * gbuffer_.render_scale,
                    h_, w_)
                # accumulate_windowed takes PIXEL centers (the volumetric
                # call above scales the same way).
                lightmap = accumulate_windowed(
                    lightmap, gbuffer_,
                    extra["projector_centers"] * gbuffer_.render_scale,
                    win_p,
                    lambda i, gbw: accumulate_projector_lights(
                        vol_t, gbw, take_light(pj, i), env_u_,
                        config.quality,
                    ),
                )

        # -- particles: bezier-path spawner, gravity, SDF collision --
        spawn_pos = evaluate_bezier(spawn_path_bezier, jnp.mod(t, 6.0))
        pc = spawn_u.position_constants.at[:, :3].set(spawn_pos[None, :])
        spawn_u_t = spawn_u.replace(
            position_constants=pc,
            velocity_matrix=evaluate_bezier_matrix(
                spawner.velocity_post_matrix, jnp.mod(t, 4.0)
            ),
        )
        k = jax.random.fold_in(key, i)
        state = spawn_fn(state, spawn_u_t, spawn_count, k,
                         spawner.spawn_max, sub_rings=spawn_sub_rings)
        pos, vel = tx.apply_gravity(state.position, state.velocity, grav_u,
                                    su)
        state = state.replace(position=pos, velocity=vel)
        state = integrate_with_distance_field(state, su, rd, vol_t,
                                              substeps=substeps)

        # -- particle rasterization (full-res, tiled) --
        if mesh is not None and mesh.devices.size > 1:
            # Row-banded bucketed raster: one all_to_all routes each
            # particle to its band owner(s); the sort/bin/splat run
            # shard-local (the GSPMD fallback all-gathers the whole
            # sort key set to every device — PARALLEL.md inventory).
            from .parallel.raster import rasterize_tiled_sharded

            particle_img, diag = rasterize_tiled_sharded(
                mesh, raster_config,
                state.position[:, 0],
                state.position[:, 1],
                state.render_color,
                state.render_data[:, 0],
                state.live_mask(),
            )
        else:
            particle_img, diag = rasterize_tiled(
                raster_config,
                state.position[:, 0],
                state.position[:, 1],
                state.render_color,
                state.render_data[:, 0],
                state.live_mask(),
            )
        # bf16 composite: feeds only the histogram (log-bucket index) and
        # the uint8 tonemap — 0.4% relative precision is invisible there
        # and the (H, W, 3) plane is written+read twice per frame.
        scene_hdr = (lightmap + particle_img[..., :3]).astype(jnp.bfloat16)

        # -- HDR histogram -> auto-exposure for the NEXT frame --
        # Full resolution: a 2x subsample of this image (strided slice or
        # reshape-mean pooling) is itself a pass over the image, like the
        # direct-index one-hot histogram. The reference's mip-level
        # accuracyFactor was a bandwidth concession.
        hist = compute_histogram(scene_hdr, hist_bounds)
        p95 = percentile(hist, 95.0)
        new_avg = avg_lum * 0.95 + p95 * 0.05  # temporal smoothing

        # -- tonemap resolve (Uncharted2 + sRGB-ish gamma) to uint8 --
        exposure = 1.1 / jnp.maximum(avg_lum, 0.05)
        mapped = tm.uncharted2_tonemap(
            scene_hdr.astype(jnp.float32) * exposure)
        white = tm.uncharted2_tonemap(jnp.float32(4.0))
        rgb = jnp.clip(mapped / white, 0.0, 1.0) ** (1.0 / 2.2)
        img = (rgb * 255.0 + 0.5).astype(jnp.uint8)

        return img, state, new_avg, diag["dropped"]

    @partial(jax.jit, donate_argnums=(0,))
    def _frame_jit(state: ParticleState, avg_lum, key, volume_, gbuffer_,
                   lights_, env_u_, spawn_count, frame_index):
        return _frame_body(frame_index, state, avg_lum, key,
                           volume_, gbuffer_, lights_, env_u_, spawn_count)

    def frame(state: ParticleState, avg_lum, key, volume_, gbuffer_,
              lights_, env_u_, spawn_count, frame_index=0):
        """One frame. `frame_index` drives the scene dynamics (the
        benched frame_loop threads i0 + j the same way) — a frozen 0
        here silently made every single-frame caller render t=0
        geometry."""
        return _frame_jit(state, avg_lum, key, volume_, gbuffer_,
                          lights_, env_u_, spawn_count,
                          jnp.asarray(frame_index, jnp.int32))

    @partial(jax.jit, donate_argnums=(0,), static_argnames=("n_frames",))
    def frame_loop(state: ParticleState, avg_lum, key, volume_, gbuffer_,
                   lights_, env_u_, spawn_count, i0, n_frames: int):
        """n_frames full frames in ONE dispatch — amortizes the
        per-dispatch host cost so benchmarks measure device throughput."""
        h, w = gbuffer_.z.shape

        def body(j, carry):
            state, avg_lum, _, drops = carry
            img, state, avg_lum, dropped = _frame_body(
                i0 + j, state, avg_lum, key, volume_, gbuffer_, lights_,
                env_u_, spawn_count,
            )
            return state, avg_lum, img, jnp.maximum(drops, dropped)

        state, avg_lum, img, drops = jax.lax.fori_loop(
            0, n_frames, body,
            (state, avg_lum, jnp.zeros((h, w, 3), jnp.uint8),
             jnp.asarray(0, jnp.int32)),
        )
        return img, state, avg_lum, drops

    return FlagshipScene(
        config=config,
        environment=env,
        sdf_config=sdf_config,
        volume=voxel_static if field == "voxel" else volume,
        gbuffer=gbuffer,
        sphere_lights=sphere_lights,
        system=system,
        raster_config=raster_config,
        frame=frame,
        frame_loop=frame_loop,
        spawner=spawner,
        extra_lights=extra,
    )
