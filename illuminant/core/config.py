"""Configuration dataclasses.

Mirrors the reference's plain-object config system (SURVEY.md §5.6):
RendererConfiguration + RendererQualitySettings
(/root/reference/Illuminant/Lighting/LightingRenderer.Configuration.cs),
HDRConfiguration (LightingRenderer.HDR.cs:198-258). All values here are
*static* for jit purposes — changing one recompiles the frame step, which
matches how rarely the reference mutates them.
"""

from __future__ import annotations

from ..core.pytree import pytree_dataclass, static_field


@pytree_dataclass
class QualitySettings:
    """Cone-trace quality knobs (LightingRenderer.Configuration.cs:254-291)."""

    min_step_size: float = static_field(default=3.0)
    long_step_factor: float = static_field(default=1.0)
    max_step_count: int = static_field(default=64)
    max_cone_radius: float = static_field(default=24.0)
    cone_growth_factor: float = static_field(default=1.0)
    occlusion_to_opacity_power: float = static_field(default=1.0)
    # Fast-path knob: scan-shadow resolution relative to the lightmap.
    # Library default 0.5: cone-softened shadows are band-limited, so the
    # visibility field is computed at half resolution and bilinearly
    # upsampled — the same accuracy lever as the reference's RenderScale /
    # histogram accuracyFactor family. Every scene (demo, bench, tests)
    # uses this default; set 1.0 for pixel-exact shadow edges.
    shadow_scale: float = static_field(default=0.5)
    # 3D refinement samples per (light, pixel) on the scan path: 0 = pure
    # flatland scan (fastest), >= 1 re-evaluates the analytic scene on the
    # true 3D ray, restoring the reference's 3D shadow behavior (short
    # obstructions don't shadow rays passing over them). Default 1:
    # measured against the exact march over tall/short/mixed obstruction
    # scenes, the second sample changes mean |error| by < 0.006 and
    # usually by zero (tests/test_refine_quality.py), while each sample
    # is a full scene evaluation per (light, pixel).
    scan_refine_samples: int = static_field(default=1)
    # Scan NOMINATION resolution relative to the shadow resolution: the
    # sequential column walk (the scan's dominant cost) only NOMINATES
    # each pixel's blocker; the per-pixel 3D refinement + cone
    # visibility still evaluate at full shadow resolution. 0.5 halves
    # the walk's grid (blocker positions quantize to 2 shadow px,
    # flatland contact edges soften by one bilinear lobe) while
    # penumbrae, refine samples, and cone radii stay full-res. Library
    # default 0.5: measured AT OR BELOW the full-res walk's error vs
    # the exact march on every test scene class — the coarse walk's
    # bilinear k smooths the arg-min's nearest-column quantization
    # (tests/test_refine_quality.py, tests/test_scan_shadows.py) — on a
    # quarter of the walk's cells. Power-of-two scales
    # (0.5, 0.25, ...) halve while dims stay even; set 1.0 for a
    # grid-exact walk. The parity preset uses 0.25 under its full-res
    # readout (error measured at the full-res walk's level).
    scan_nomination_scale: float = static_field(default=0.5)
    # ColumnField (voxel fast path) 3D-refine mode. "carried": the scan
    # carries the nominated blocker column's (h_top, h_bot) interval and
    # the refine reconstructs candidate distances ELEMENTWISE
    # (columns.reconstruct_profile) — zero scattered field samples;
    # exact for z-prism content, CONSERVATIVE (over-shadow, measured
    # ~3% of (light, px) > 0.1 visibility on moving convex occluders,
    # 88% in the darker direction; image-level bound pinned in
    # tests/test_voxel_flagship.py) near shapes whose horizontal
    # cross-section varies with z. "exact": candidates sample the
    # underlying voxel volume (the reference-trilinear path — matches
    # the analytic frame to voxel quantization, but pays one scattered
    # volume sample per candidate; PERF.md has its cost on the GPU).
    # Analytic scenes sample exactly under both defaults — their
    # closed-form evals are cheaper than the 4 extra walk carries the
    # carried mode adds; "carried_all" opts analytic scenes into the
    # carried machinery anyway (for A/B and windowless memory-bound
    # scenes).
    scan_refine_mode: str = static_field(default="carried")
    # Resolution of the EXTRA light families (directional/line/
    # volumetric/particle) relative to the lightmap, when a scene opts
    # into the multi-family frame. 0.5 = the library default: those
    # terms are band-limited on flat scenes, so they evaluate at half
    # resolution and upsample — the reference's own per-light lever
    # (LightSource.Quality + RendererConfiguration.RenderScale). The
    # half-vs-full error is MEASURED on the flagship G-buffer
    # (tests/test_advice_r4.py pins the bound). 1.0 = evaluate every
    # family at lightmap resolution (the parity preset's choice —
    # LightingRenderer.cs:1004-1168 shades all families at lightmap
    # res). Only 1.0 and even-divisor scales (0.5) are supported.
    extra_family_scale: float = static_field(default=0.5)


@pytree_dataclass
class RendererConfig:
    """Lighting renderer configuration
    (LightingRenderer.Configuration.cs:13-253, array-relevant subset).

    The lightmap is always f32 HDR (the HighQuality HalfVector4-vs-Color
    switch was a GPU bandwidth concession); RingBufferSize/GarbageCollect*
    buffer-pool knobs have no equivalent here (state is functional).
    """

    width: int = static_field(default=1920)
    height: int = static_field(default=1080)
    render_scale: float = static_field(default=1.0)
    two_point_five_d: bool = static_field(default=False)
    render_ground_plane: bool = static_field(default=True)
    enable_gbuffer: bool = static_field(default=True)
    maximum_field_updates_per_frame: int = static_field(default=1)
    enable_brightness_estimation: bool = static_field(default=False)
    quality: QualitySettings = static_field(default_factory=QualitySettings)

    @property
    def lightmap_shape(self):
        h = int(round(self.height * self.render_scale))
        w = int(round(self.width * self.render_scale))
        return (h, w)


@pytree_dataclass
class HDRConfig:
    """HDR resolve configuration (LightingRenderer.HDR.cs:198-258).

    mode: 0 = none, 1 = gamma-compress, 2 = Uncharted2 tonemap.
    """

    mode: int = static_field(default=0)
    exposure: float = static_field(default=1.0)
    gamma: float = static_field(default=1.0)
    white_point: float = static_field(default=1.0)
    middle_gray: float = static_field(default=0.6)
    maximum_luminance_sq: float = static_field(default=1.0)
    offset: float = static_field(default=0.0)
    dithering: bool = static_field(default=False)
    srgb_output: bool = static_field(default=False)

HDR_MODE_NONE = 0
HDR_MODE_GAMMA_COMPRESS = 1
HDR_MODE_TONEMAP = 2
