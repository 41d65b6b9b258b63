"""Scan-propagated soft shadows: the gather-free fast path.

The reference cone-traces every (pixel, light) ray through the SDF with a
64-step budget (ConeTrace.fxh), a data-dependent loop of scattered field
samples per ray. This module reformulates the
same math as a GATHER-FREE column scan:

  * One dense analytic occlusion image `occ[y, x] = scene_sdf(pixel)` per
    frame (shared by every light) — pure vector math over the pixel grid.
  * Per light, visibility propagates outward column-by-column (lax.scan).
    A ray to pixel (x, y) passes the previous column at
    y_src = y - (y - y_l)/(x - x_l), which for the sector's own wedge
    (|slope| <= 1) is always within +-1 row — so the propagation step is a
    lerp of static +-1 rolls. Four sector passes (E/W and N/S on the
    transpose) cover the plane.
  * The carry is (min distance along ray, arg-distance of that min) — an
    associative min+argmin — and the pixel reads the carry BEFORE its own
    column sample merges (the trace-initial-offset exclusion).
  * Readout applies the reference's cone formula at the pixel:
    vis = (d* + HACK_DISTANCE_OFFSET) / cone_radius(u*) with the radius
    grown from the pixel toward the light (createTraceConfig,
    ConeTrace.fxh:122-139) evaluated at the blocking sample's distance,
    then the shadowed/unshadowed thresholds and occlusion power
    (fxh:182-189).

Exactness vs the reference march: the scan takes the TRUE minimum along
the ray (the march approximates it with adaptive steps), so edges are
slightly cleaner. The flatland scan alone evaluates occlusion at one
trace height; the 3D REFINEMENT stage (QualitySettings.scan_refine_samples,
default 2) then re-evaluates the analytic scene at 1-3 true 3D ray
positions chosen from the scan's carries (arg-min, blocker midpoint,
blocker exit), restoring the reference's 3D behavior — short obstructions
don't shadow rays passing over them, elevated surfaces clear ground
obstructions. Remaining trade-off vs the march: the cone radius divides
only the refined candidate samples instead of every step (penumbra growth
matches; deep-umbra values can differ slightly). The march in
cone_trace.py remains the exact oracle.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.config import QualitySettings
from ..sdf.analytic import scene_sample_p
from ..core.platform import platform_choice
from ..core.pytree import named_scope
from .cone_trace import (
    FULLY_SHADOWED_THRESHOLD,
    HACK_DISTANCE_OFFSET,
    MIN_CONE_RADIUS,
    UNSHADOWED_THRESHOLD,
)

_BIG = 1e9

# --- Trace-time SPMD context (multi-chip frames) ---------------------
# Set by a frame body (scenes.py) while it traces, via `spmd_mesh(mesh)`.
# When active, every scan call in the frame splits into two sharding
# domains:
#   * the sequential NOMINATION walks run REPLICATED — their
#     (3, 2, L, H)-layout +-1-row rolls along the sharded pixel axis
#     would otherwise lower to cross-shard collective-permutes INSIDE
#     the lax.scan body: hundreds of rendezvous per frame, which raced
#     and deadlocked XLA:CPU's collective rendezvous (the round-3
#     SIGABRT). The walk runs at nomination resolution
#     (default lightmap/8 area), so replicating it costs each chip a
#     small redundant compute instead of per-step halo traffic;
#   * the per-pixel REFINE/READOUT (the scan's dominant cost: K analytic
#     scene evals + cone math per (light, pixel)) is pinned row-sharded,
#     scaling with the mesh like the rest of the lighting resolve.
# One well-formed reshard at the nomination->readout boundary replaces
# the in-loop collective storm.
import contextlib

_SPMD_MESH = None


@contextlib.contextmanager
def spmd_mesh(mesh):
    """Activate SPMD sharding hints for scan calls traced in this scope
    (no-op when mesh is None)."""
    global _SPMD_MESH
    prev = _SPMD_MESH
    _SPMD_MESH = mesh
    try:
        yield
    finally:
        _SPMD_MESH = prev


def _pin_replicated(x):
    if _SPMD_MESH is None:
        return x
    from jax.sharding import NamedSharding, PartitionSpec as P

    return jax.lax.with_sharding_constraint(
        x, NamedSharding(_SPMD_MESH, P()))


def _pin_rows(x):
    """Shard the second-to-last axis (the pixel-row axis of (..., H, W))
    over the mesh."""
    if _SPMD_MESH is None:
        return x
    from jax.sharding import NamedSharding, PartitionSpec as P

    axis = _SPMD_MESH.axis_names[0]
    spec = [None] * x.ndim
    spec[x.ndim - 2] = axis
    return jax.lax.with_sharding_constraint(
        x, NamedSharding(_SPMD_MESH, P(*spec)))


def occlusion_image(scene, height: int, width: int, trace_z,
                    render_scale: float = 1.0, world_offset=None):
    """Dense scene distance at every pixel center, at height trace_z.

    `scene` is any field queryable by scene_sample_p — the analytic scene
    (gather-free, the fast path) or a voxel SdfVolume (loaded/polygonal
    fields; trilinear gathers, correct but slower). `world_offset`
    ((2,) [x, y], world units): the top-left corner of a windowed view
    (GBuffer.window)."""
    ys = (jnp.arange(height, dtype=jnp.float32) + 0.5) / render_scale
    xs = (jnp.arange(width, dtype=jnp.float32) + 0.5) / render_scale
    if world_offset is not None:
        xs = xs + world_offset[0]
        ys = ys + world_offset[1]
    return scene_sample_p(scene, xs[None, :], ys[:, None], trace_z)


# lax.scan unroll of the nomination walk, per platform. CPU: 1 — an
# unrolled body makes the XLA CPU compile pathologically slow (minutes
# for a 256-column scan), and CPU runs are about semantics. GPU: 32, the
# fastest of 1/4/8/32 on the 1080p fast and parity frames (H100: 4.15
# and 5.07 ms/frame vs 4.87 and 5.65 at 8, for ~17 s more compile per
# frame; PERF.md). ILLUM_SCAN_UNROLL overrides (sweeps).
SCAN_UNROLL_BY_PLATFORM = {"cpu": 1, "gpu": 32}


def _default_unroll() -> int:
    import os

    env = os.environ.get("ILLUM_SCAN_UNROLL")
    if env:
        return int(env)
    return platform_choice(SCAN_UNROLL_BY_PLATFORM, "scan unroll")


def _bidirectional_scan(occ, light_x, light_y, light_radius, unroll=None,
                        raw=False, exit_band=1.0, extra=None,
                        footprint=None):
    """Both half-plane passes in ONE lax.scan (the reverse pass runs on the
    flipped image as a batch row — halves the sequential op count; unroll
    amortizes per-step overhead). occ: (H, W); light_x/y/radius: (L,).

    Returns ((e_d, e_k), (w_d, w_k)): (L, H, W) pre-merge carries — the min
    scene distance along each pixel's ray (excluding the pixel's own
    column) and the horizontal distance from the light where it occurred.

    `extra`: optional tuple of (H, W) images whose values are SELECTED
    (not min-propagated) whenever the running arg-min updates — the
    carried payload reads "image value at the nominated blocker". Used
    by the carried-interval refine to ride the blocker column's
    interval (h_top, h_bot) along the walk.

    `footprint`: optional (H, W) FOOTPRINT-distance image; when given,
    its running MINIMUM along each ray rides the walk as a fourth
    lerp-resampled carry (associative like min_d — no payload-style
    transport needed). The refine uses it as the reconstruction's f
    term: selecting f at the arg-min column instead under-darkened
    nothing but under-SHADOWED short blockers whose flat plane
    distance puts the arg-min at the footprint's entry edge (f ~ 0,
    not the interior depth — measured mean err 0.06 vs the exact
    refine's 0.019 on test_refine_quality's 'mixed').

    Each sector tuple is (d, k, neg_k[, f_min], *extra) — f_min
    present iff `footprint` is.

    raw=True returns the scan outputs in their NATIVE (W, 2, L, H) f16
    layout (forward-pass x-mirror NOT undone) — for layout experiments
    (a native-layout sector select would transpose only the 3 selected
    arrays instead of the production path's six moveaxis transposes).
    """
    H, W = occ.shape
    L = light_x.shape[0]
    # Sample CENTERS at i + 0.5 (occlusion_image samples there; the
    # light coordinates arrive as continuous world * scale).
    ys = jnp.arange(H, dtype=jnp.float32)[None, None, :] + 0.5

    cols = jnp.arange(W, dtype=jnp.float32) + 0.5
    # Row 0: east pass on occ; row 1: west pass on the flipped image with
    # a mirrored light x. Under the center convention, index flip
    # i -> W-1-i maps center c -> W - c.
    occ_fwd = occ.T  # (W, H)
    occ_rev = occ.T[::-1]
    occ_both = jnp.stack([occ_fwd, occ_rev], axis=1)  # (W, 2, H)
    n_extra = 0 if extra is None else len(extra)
    extra_both = tuple(
        jnp.stack([m.T, m.T[::-1]], axis=1) for m in (extra or ()))
    fp_both = (None if footprint is None else
               jnp.stack([footprint.T, footprint.T[::-1]], axis=1))

    lx = jnp.stack([light_x, float(W) - light_x], axis=0)[:, :, None]
    ly = jnp.broadcast_to(light_y[None, :, None], (2, L, 1))
    lr = jnp.broadcast_to(light_radius[None, :, None], (2, L, 1))
    # The per-column k outputs are stored f16; for a far off-screen
    # light (the directional pseudo-center, |lx| in the thousands) dx is
    # large and the f16 step reaches ~8px — enough to push the 3D-refine
    # sample off its blocker. Store k + k_off (for lx = -D, dx is in
    # [D, D+W] and k_off = -D, so the stored value stays within [0, W])
    # and subtract k_off back at readout.
    k_off = jnp.minimum(lx, 0.0)

    # Three separate carries, not one stacked (3, 2, L, H) array sharing
    # the fan-resample rolls: the leading stack dim broke the (2, L, H)
    # layout and was measured slower.
    def step(carry, inputs):
        (min_d, min_k, neg_k), f_min, extra_c, ph = carry
        x, occ_col, fp_col, extra_cols = inputs  # (), (2, H), ...
        dx = x - lx  # (2, L, 1)
        in_front = dx >= 1.0

        # Resample the carries along the ray fan: y_src = y - f,
        # f = (y - yl)/dx in [-1, 1] inside the wedge.
        f = (ys - ly) / jnp.maximum(dx, 1.0)
        f = jnp.clip(f, -1.0, 1.0)

        af = jnp.abs(f)
        near = 1.0 - af

        def resample(c, edge_fill):
            # jnp.roll wraps; rays leaving the image must read "no
            # occlusion yet", not the opposite edge's carry (an occluder
            # at the bottom edge otherwise leaks a shadow streak onto the
            # top rows along the sector diagonal).
            up = jnp.roll(c, 1, axis=2)  # index y -> value at y-1
            dn = jnp.roll(c, -1, axis=2)
            row = jnp.arange(c.shape[2])
            up = jnp.where(row == 0, edge_fill, up)
            dn = jnp.where(row == c.shape[2] - 1, edge_fill, dn)
            return c * near + jnp.where(f >= 0.0, up, dn) * af

        res_d = resample(min_d, _BIG)
        res_k = resample(min_k, 0.0)
        res_n = resample(neg_k, 0.0)
        # Outside the light's half-plane nothing has accumulated yet.
        res_d = jnp.where(in_front, res_d, _BIG)
        res_k = jnp.where(in_front, res_k, 0.0)
        res_n = jnp.where(in_front, res_n, 0.0)

        # Argmin-selected payloads (blocker h_top/h_bot/footprint)
        # follow the fan by SHIFTED COPY instead of lerping: a lerp
        # between a tall blocker's top and a neighboring column's
        # unrelated height undercuts t* and lets refined rays "pass
        # over" shadows that the exact sampler blocks (measured: vis
        # 1.0 vs 0.06 worst-pixel). The shift is PHASE-CORRECTED: a
        # plain af > 0.5 nearest-neighbor never moves the payload on
        # rays with |slope| < 0.5 row/col while the true fan drifts
        # f rows per column — a LINEAR position error that read
        # unrelated columns' data tens of rows off the ray (measured:
        # diagonal bands of fully-lost shadows, carried-vs-exact diff
        # 1.0, test_refine_quality 'mixed'). Carrying the accumulated
        # fractional row phase and rounding (f + phase) each step
        # bounds the transport error at half a row; the phase RESETS
        # where the argmin update takes fresh column data.
        if n_extra:
            shift = jnp.clip(jnp.round(f + ph), -1.0, 1.0)

            def resample_shift(c, edge_fill):
                up = jnp.roll(c, 1, axis=2)
                dn = jnp.roll(c, -1, axis=2)
                row = jnp.arange(c.shape[2])
                up = jnp.where(row == 0, edge_fill, up)
                dn = jnp.where(row == c.shape[2] - 1, edge_fill, dn)
                return jnp.where(shift > 0.5, up,
                                 jnp.where(shift < -0.5, dn, c))

            # (h_top, h_bot) neutral fills — a huge interval
            # reconstructs at the footprint term alone; min_d's own
            # _BIG fill gates has_blocker on these rays anyway.
            _FILLS = (4096.0, -4096.0)
            res_e = tuple(
                jnp.where(in_front, resample_shift(c, fill), fill)
                for c, fill in zip(extra_c, _FILLS))
            res_ph = jnp.where(
                in_front, resample_shift(ph, 0.0) + f - shift, 0.0)
        else:
            res_e = ()
            res_ph = None

        # Merge this column's own sample (skipped within the light radius —
        # the trace stops `radius` short of the light, ConeTrace.fxh:46).
        sample_valid = in_front & (dx > lr)
        d_here = jnp.where(sample_valid, occ_col[:, None, :], _BIG)
        new_min_d = jnp.minimum(res_d, d_here)
        if fp_col is not None:
            # Running footprint minimum: associative like min_d, so it
            # lerp-resamples along the fan (no payload transport).
            res_f = jnp.where(in_front, resample(f_min, _BIG), _BIG)
            f_here = jnp.where(sample_valid, fp_col[:, None, :], _BIG)
            new_f_min = jnp.minimum(res_f, f_here)
        else:
            res_f = new_f_min = None
        upd = d_here < res_d
        new_min_k = jnp.where(upd, dx, res_k)
        new_extra = tuple(
            jnp.where(upd, col[:, None, :], re)
            for col, re in zip(extra_cols, res_e))
        # Fresh column data is ON the ray exactly — reset the phase.
        new_ph = jnp.where(upd, 0.0, res_ph) if n_extra else None
        # Blocker EXIT point: the farthest-from-light NEAR-SURFACE sample
        # — the ray is lowest there, so it's the second 3D-refine
        # candidate. The threshold is a small positive band, not 0: a
        # blocker whose top sits exactly at the trace plane grazes the
        # flatland ray with d ~ 0 and never negative; a strict d < 0
        # left the exit empty, collapsed the refine span onto its start
        # (where the descending true ray is still above the blocker) and
        # erased the whole shadow (measured p99 = 1.0 slivers on the
        # 3-occluder scene, tools/approx_artifacts.py). The band is
        # RELATIVE to the running minimum as well as absolute: a SHORT
        # blocker below the trace plane reads a flat d = (plane - top)
        # band across its whole footprint and the absolute test never
        # fired — the span collapsed to the entry column, where the
        # descending true ray is still high, and the carried 3D refine
        # under-shadowed the whole class (test_refine_quality 'short':
        # mean err 0.092 -> 0.075 with the relative band).
        new_neg_k = jnp.where(
            d_here < jnp.maximum(exit_band, new_min_d + exit_band),
            dx, res_n)
        # Per-column outputs are the scan's big materialization
        # (3 x (W, 2, L, H) per pass); store them f16 — d <= 128 keeps
        # ~0.06 precision, k <= W keeps ~1 shadow-res px — and upcast at
        # readout. Halves the pass's HBM traffic.
        return (
            (new_min_d, new_min_k, new_neg_k), new_f_min, new_extra,
            new_ph,
        ), (
            res_d.astype(jnp.float16),
            (res_k + k_off).astype(jnp.float16),
            (res_n + k_off).astype(jnp.float16),
            None if res_f is None else res_f.astype(jnp.float16),
            tuple(r.astype(jnp.float16) for r in res_e),
        )

    _EX_INIT = (4096.0, -4096.0)
    init = (
        (
            jnp.full((2, L, H), _BIG, jnp.float32),
            jnp.zeros((2, L, H), jnp.float32),
            jnp.zeros((2, L, H), jnp.float32),
        ),
        (None if footprint is None
         else jnp.full((2, L, H), _BIG, jnp.float32)),
        tuple(jnp.full((2, L, H), _EX_INIT[i], jnp.float32)
              for i in range(n_extra)),
        jnp.zeros((2, L, H), jnp.float32) if n_extra else None,
    )
    _, (pre_d, pre_k, pre_n, pre_f, pre_e) = jax.lax.scan(
        step, init, (cols, occ_both, fp_both, extra_both),
        unroll=_default_unroll() if unroll is None else unroll,
    )
    if raw:
        return pre_d, pre_k, pre_n
    # (W, 2, L, H) -> (2, L, H, W).
    pre_d = jnp.moveaxis(pre_d, 0, 3)
    pre_k = jnp.moveaxis(pre_k, 0, 3)
    pre_n = jnp.moveaxis(pre_n, 0, 3)
    pre_f = None if pre_f is None else jnp.moveaxis(pre_f, 0, 3)
    pre_e = tuple(jnp.moveaxis(p, 0, 3) for p in pre_e)
    fs = () if pre_f is None else (pre_f,)
    east = (pre_d[0], pre_k[0], pre_n[0]) \
        + tuple(p[0] for p in fs) + tuple(p[0] for p in pre_e)
    west = (pre_d[1, :, :, ::-1], pre_k[1, :, :, ::-1],
            pre_n[1, :, :, ::-1]) \
        + tuple(p[1, :, :, ::-1] for p in fs) \
        + tuple(p[1, :, :, ::-1] for p in pre_e)
    return east, west


@named_scope("illuminant/scan_shadows")
def scan_visibility(
    scene,
    height: int,
    width: int,
    light_position,  # (L, 3)
    light_radius,  # (L,)
    light_ramp_length,  # (L,)
    quality: QualitySettings,
    trace_z=None,
    render_scale: float = 1.0,
    pixel_z=None,
    pixel_offset_xy=None,
    max_trace_distance=None,  # (L,) world units; None = to image edge
    world_offset=None,  # (2,) world-unit window origin (GBuffer.window)
    light_active=None,  # (L,) 0/1; masks PADDED slots out of trace_z
):
    """Cone-trace-equivalent visibility for all lights -> (L, H, W).

    `max_trace_distance` mirrors the march's trace budget (blockers
    farther than this from the SHADED PIXEL along the ray are ignored —
    DirectionalLightSource.ShadowTraceLength semantics); the radial
    sphere-light path leaves it None (trace to the light).

    `pixel_z` (H, W): shaded-surface heights. The occlusion image lives at
    one trace height, so pixels standing ABOVE it (height-volume tops)
    would self-shadow; their true rays clear the occluders, so visibility
    fades back to 1 as the surface rises past the trace plane (the 3D
    march has no such artifact — see PERF.md approximations)."""
    windowed_eval = world_offset is not None
    if world_offset is None:
        world_offset = jnp.zeros((2,), jnp.float32)
    lz = light_position[:, 2]
    if trace_z is None:
        # Active-weighted mean: light sets arrive PADDED to a fixed
        # capacity with zero positions (pack_sphere_lights) — an
        # unmasked mean would drag the trace plane toward the floor as
        # pad capacity grows (shadow shape changing with an unrelated
        # host parameter).
        if light_active is not None:
            aw = light_active.astype(jnp.float32)
            trace_z = jnp.sum(lz * aw) / jnp.maximum(jnp.sum(aw), 1.0) \
                * 0.4
        else:
            trace_z = jnp.mean(lz) * 0.4

    # --- NOMINATION: the sequential column walks + sector merge. Its
    # outputs are per-pixel, resolution-INDEPENDENT quantities — min
    # scene distance along the ray (world units) and the blocker entry/
    # exit positions as FRACTIONS of the ray — so the walk (the scan's
    # dominant sequential cost) can run on a coarser grid than the
    # refine/cone readout below (QualitySettings.scan_nomination_scale):
    # blocker positions then quantize to 1/scale shadow px and flatland
    # contact edges soften by one bilinear lobe, while the per-pixel 3D
    # refinement, cone radii and penumbra thresholds all stay at the
    # full shadow resolution.
    nm = quality.scan_nomination_scale
    # Power-of-two nomination scales only (each halving is one exact
    # 2x bilinear upsample at readout); dims must stay even.
    halvings = 0
    nh, nw, nscale = height, width, render_scale
    nm_left = nm
    while (nm_left <= 0.5 + 1e-6 and nh % 2 == 0 and nw % 2 == 0
           and min(nh, nw) >= 16):
        nh, nw, nscale = nh // 2, nw // 2, nscale * 0.5
        nm_left *= 2.0
        halvings += 1
    use_nom = halvings > 0
    # Window-local pixel coordinates: shift the light into the window's
    # frame so the column scan's dx math is unchanged.
    lx = (light_position[:, 0] - world_offset[0]) * nscale
    ly = (light_position[:, 1] - world_offset[1]) * nscale
    occ = occlusion_image(scene, nh, nw, trace_z, nscale, world_offset)

    # The near-light sample skip inside the walk (dx > radius — the trace
    # stops `radius` short of the light, ConeTrace.fxh:46) compares dx in
    # NOMINATION-GRID pixels, so the world-unit radius must be rescaled;
    # unscaled it would carve a radius/nscale dead zone in which occluders
    # near a light cast no shadow at all (4x radius at the defaults).
    occ = _pin_replicated(occ)
    lr_n = light_radius * nscale
    # ColumnField scenes: ride the blocker column's interval (h_top,
    # h_bot) through the walk as selected-at-argmin payload; the 3D
    # refine below then reconstructs the candidate distances
    # ELEMENTWISE (columns.reconstruct_profile with the flatland min as
    # the footprint term) instead of scatter-sampling the field — the
    # voxel path's refine cost drops from N_px * map-matmul to pure
    # vector math.
    from ..sdf.columns import ColumnField, reconstruct_profile, \
        resample_map_to_grid

    # WINDOWED evaluations (volumetric/projector sub-frame windows —
    # world_offset given) keep the exact per-candidate sampling: their
    # grids are small, so the exact refine is cheap there, and the
    # carried maps' grid quantization made windowed lights visibly
    # resolution-dependent (the halfres extra-family frame diverged
    # 15% of volumetric pixels > 2 LSB carried vs 0.09% exact —
    # tests/test_advice_r4.py). Carried stays for the expensive
    # full-frame scans, whose error is pinned against the march at
    # both nomination scales (test_refine_quality).
    want_carried = (quality.scan_refine_samples > 0
                    and quality.scan_refine_mode in ("carried",
                                                     "carried_all")
                    and not windowed_eval)
    use_cols = isinstance(scene, ColumnField) and want_carried
    if (isinstance(scene, ColumnField)
            and quality.scan_refine_mode == "exact"):
        # Exact mode: candidates sample the underlying volume directly
        # (scene_sample_p on an SdfVolume -> reference trilinear).
        scene = scene.volume
    ana_cols = None
    if (want_carried and not use_cols
            and quality.scan_refine_mode == "carried_all"):
        # ANALYTIC carried refine — EXPLICIT OPT-IN ("carried_all"),
        # not the default: closed-form column-interval images (the
        # analog of the ColumnField maps, built directly at the
        # nomination grid — sdf/analytic.py:scene_column_images) let
        # the 3D refine run elementwise with zero full-res scene evals.
        # Opt-in because the 4 extra walk carries cost more than the
        # cheap closed-form candidate evals they replace. ColumnField
        # (voxel) scenes keep carried as their default above: there the
        # evals it replaces are scattered volume samples. None (rotated
        # prims / polygons / many-prim scenes) keeps the exact
        # per-candidate scene sampling.
        from ..sdf.analytic import AnalyticScene

        if isinstance(scene, AnalyticScene):
            from ..sdf.analytic import scene_column_images

            ana_cols = scene_column_images(scene, nh, nw, nscale,
                                           world_offset)
            use_cols = ana_cols is not None
    if use_cols:
        if ana_cols is not None:
            t_img = _pin_replicated(ana_cols[0])
            b_img = _pin_replicated(ana_cols[1])
            f_img = _pin_replicated(ana_cols[2])
        else:
            t_img = _pin_replicated(resample_map_to_grid(
                scene, scene.h_top, nh, nw, nscale, world_offset))
            b_img = _pin_replicated(resample_map_to_grid(
                scene, scene.h_bot, nh, nw, nscale, world_offset))
            f_img = _pin_replicated(resample_map_to_grid(
                scene, scene.flat_d, nh, nw, nscale, world_offset))
        # (h_top, h_bot) ride the argmin as selected payloads; the
        # FOOTPRINT image rides as a lerped running-min carry — it is
        # the reconstruction's f term. The carried flatland min equals
        # the footprint when the trace plane crosses the blocker
        # interval but reads footprint + vertical offset when the
        # plane sits ABOVE a short blocker (the flatland scan's blind
        # spot); the footprint minimum recovers those shadows
        # (test_refine_quality 'short'/'mixed', see _bidirectional_scan
        # docstring for the measured steps).
        extra = (t_img, b_img)
        extra_t = (t_img.T, b_img.T)
        fp, fp_t = f_img, f_img.T
    else:
        extra = extra_t = ()
        fp = fp_t = None
    # Exit-nomination band: the last sample within this SDF distance of
    # a surface marks the blocker exit (a blocker whose top sits exactly
    # at the trace plane grazes the ray with d ~ 0 and never negative —
    # a strict d < 0 collapsed the refine span and erased its shadow).
    # Scaled to the grid: at coarse nomination the ray-fan resample
    # smears a wide band across neighboring rays and pushes exits past
    # their blockers (measured on the 'tall' scene at nomination 0.25).
    band = float(min(1.0, max(nscale, 0.25)))
    (e_d, e_k, e_n, *e_e), (w_d, w_k, w_n, *w_e) = jax.tree.map(
        _pin_replicated,
        _bidirectional_scan(occ, lx, ly, lr_n, exit_band=band,
                            extra=extra, footprint=fp),
    )
    (n_tuple, s_tuple) = jax.tree.map(
        _pin_replicated,
        _bidirectional_scan(occ.T, ly, lx, lr_n, exit_band=band,
                            extra=extra_t, footprint=fp_t),
    )
    n_d = jnp.swapaxes(n_tuple[0], 1, 2)
    n_k = jnp.swapaxes(n_tuple[1], 1, 2)
    n_n = jnp.swapaxes(n_tuple[2], 1, 2)
    s_d = jnp.swapaxes(s_tuple[0], 1, 2)
    s_k = jnp.swapaxes(s_tuple[1], 1, 2)
    s_n = jnp.swapaxes(s_tuple[2], 1, 2)
    n_e = tuple(jnp.swapaxes(p, 1, 2) for p in n_tuple[3:])
    s_e = tuple(jnp.swapaxes(p, 1, 2) for p in s_tuple[3:])

    ys_n = jnp.arange(nh, dtype=jnp.float32)[None, :, None] + 0.5
    xs_n = jnp.arange(nw, dtype=jnp.float32)[None, None, :] + 0.5
    dx_n = xs_n - lx[:, None, None]
    dy_n = ys_n - ly[:, None, None]

    # Sector select: E/W own |dy| <= |dx|, N/S the rest.
    horiz = jnp.abs(dx_n) >= jnp.abs(dy_n)
    east = horiz & (dx_n >= 0.0)
    west = horiz & (dx_n < 0.0)
    north = (~horiz) & (dy_n >= 0.0)

    min_d = jnp.where(
        east, e_d,
        jnp.where(west, w_d, jnp.where(north, n_d, s_d)),
    )
    min_k = jnp.where(
        east, e_k,
        jnp.where(west, w_k, jnp.where(north, n_k, s_k)),
    )
    neg_k = jnp.where(
        east, e_n,
        jnp.where(west, w_n, jnp.where(north, n_n, s_n)),
    )
    tb_star = tuple(
        jnp.where(east, ee, jnp.where(west, ww, jnp.where(north, nn, ss)))
        for ee, ww, nn, ss in zip(e_e, w_e, n_e, s_e))
    # Undo the f16-range k offset (see _bidirectional_scan): each sector
    # pass measured k from its own (possibly mirrored) light coordinate.
    off_e = jnp.minimum(lx, 0.0)[:, None, None]
    off_w = jnp.minimum(float(nw) - lx, 0.0)[:, None, None]
    off_n = jnp.minimum(ly, 0.0)[:, None, None]
    off_s = jnp.minimum(float(nh) - ly, 0.0)[:, None, None]
    k_off = jnp.where(
        east, off_e,
        jnp.where(west, off_w, jnp.where(north, off_n, off_s)),
    )
    min_k = min_k - k_off
    neg_k = neg_k - k_off

    major_n = jnp.maximum(
        jnp.maximum(jnp.abs(dx_n), jnp.abs(dy_n)), 1e-3
    )
    k_frac = jnp.clip(min_k / major_n, 0.0, 1.0)  # 0 at light, 1 at px
    exit_frac = jnp.clip(jnp.maximum(neg_k, min_k) / major_n, 0.0, 1.0)
    if use_nom:
        # tb_star is (f_min, h_top, h_bot) on the carried path — f_min
        # upsamples mask-normalized bilinear (a smooth distance field),
        # the heights nearest-neighbor (per-blocker constants).
        if use_cols:
            fmin_in, ex_in = tb_star[0], tb_star[1:]
        else:
            fmin_in, ex_in = None, tb_star
        min_d, k_frac, exit_frac, has_blocker, tb_star = \
            _upsample_nominated(
                min_d, k_frac, exit_frac, halvings, extras=ex_in,
                fmin=fmin_in,
            )
    else:
        has_blocker = min_d < 1e8
    # Nomination -> readout sharding boundary (see spmd_mesh above): one
    # replicated -> row-sharded reshard; the per-pixel refine below then
    # scales over the mesh.
    min_d = _pin_rows(min_d)
    k_frac = _pin_rows(k_frac)
    exit_frac = _pin_rows(exit_frac)
    has_blocker = _pin_rows(has_blocker)
    tb_star = tuple(_pin_rows(p) for p in tb_star)

    # --- READOUT at full shadow resolution. Pixel CENTERS sit at
    # (i + 0.5) in grid coordinates (occlusion_image samples there) —
    # the +0.5 keeps the scan's blocker positions and refine endpoints
    # aligned with the march's world_position() convention.
    lx = (light_position[:, 0] - world_offset[0]) * render_scale
    ly = (light_position[:, 1] - world_offset[1]) * render_scale
    ys = jnp.arange(height, dtype=jnp.float32)[None, :, None] + 0.5
    xs = jnp.arange(width, dtype=jnp.float32)[None, None, :] + 0.5
    dx = xs - lx[:, None, None]
    dy = ys - ly[:, None, None]
    adx = jnp.abs(dx)
    ady = jnp.abs(dy)

    # Convert major-axis extents to along-ray WORLD distances: the grid
    # walks shadow-resolution px (world * render_scale), but the cone
    # radius growth, HACK_DISTANCE_OFFSET and the scene distances are
    # world units — sec converts in one multiply (u = frac * major *
    # sec). A px-unit u understated penumbra growth by 1/render_scale
    # at shadow_scale < 1 (measured: penumbra-band error 0.31 vs the
    # march at shadow 0.5, 0.11 at full res, pre-fix).
    major = jnp.maximum(jnp.maximum(adx, ady), 1e-3)
    # pixel_z is (H, W) shared, or (L, H, W) per-light (fused multi-
    # family calls lift the shading endpoint by each family's constant).
    if pixel_z is None:
        pz = jnp.zeros((1,) + min_d.shape[1:], jnp.float32)
    else:
        pz = pixel_z if pixel_z.ndim == 3 else pixel_z[None]
    dz = pz - lz[:, None, None]
    inv_rs = 1.0 / jnp.maximum(render_scale, 1e-6)
    ray_len_w = jnp.sqrt(
        (dx * dx + dy * dy) * (inv_rs * inv_rs) + dz * dz)
    sec = ray_len_w / major

    # createTraceConfig (ConeTrace.fxh:122-139) + coneTraceStep (fxh:51-71).
    max_radius = jnp.clip(
        light_radius[:, None, None], MIN_CONE_RADIUS,
        quality.max_cone_radius,
    )
    ramp = jnp.maximum(light_ramp_length[:, None, None], 16.0)
    growth = max_radius / ramp * quality.cone_growth_factor

    # --- 3D refinement: the 2D scan only NOMINATES the blocker (arg-min at
    # the trace height); a short analytic mini-march over the blocker ->
    # pixel segment of the TRUE 3D ray then replaces the flatland distance
    # (each sample with its own cone radius, like the reference march).
    # This restores 3D behavior — short obstructions don't shadow pixels
    # whose rays pass over them, elevated pixels' rays clear ground
    # obstructions — at the cost of K analytic evals per (light, pixel).
    px_x = xs * inv_rs + world_offset[0]
    px_y = ys * inv_rs + world_offset[1]
    # Ray endpoints: light (world) -> shaded surface. The self-occlusion
    # lift the march applies (SphereLightCore.fxh:151) must follow the
    # SURFACE NORMAL (callers pass pixel_z/pixel_offset_xy already
    # normal-lifted) — a pure +z lift leaves vertical-face pixels inside
    # their own volume and blackens them.
    pz_lift = pz
    if pixel_offset_xy is not None:
        off = (pixel_offset_xy if pixel_offset_xy.ndim == 4
               else pixel_offset_xy[None])
        px_x = px_x + off[..., 0]
        px_y = px_y + off[..., 1]
    lx_w = light_position[:, 0][:, None, None]
    ly_w = light_position[:, 1][:, None, None]
    if max_trace_distance is not None:
        # Blocker distance from the pixel along the ray, in world units
        # (major * sec IS world ray length now).
        u_blocker = jnp.maximum((1.0 - k_frac) * major * sec, 0.0)
        has_blocker = has_blocker & (
            u_blocker <= max_trace_distance[:, None, None]
        )
    if quality.scan_refine_samples <= 0:
        # Pure flatland: use the scan's own 2D min directly.
        u0 = jnp.maximum((1.0 - k_frac) * major * sec, 0.0)
        radius0 = jnp.minimum(growth * u0 + MIN_CONE_RADIUS, max_radius)
        vis = jnp.minimum(
            (min_d + HACK_DISTANCE_OFFSET) / radius0, 1.0
        )
        if max_trace_distance is not None:
            vis = jnp.where(has_blocker, vis, 1.0)
        candidates = ()
    else:
        # Primary candidate: the arg-min itself when the flatland
        # interior is DEEP (a real footprint crossing — probing the span
        # middle instead reads the shallower off-center distance and the
        # +HACK_DISTANCE_OFFSET washes the umbra: measured 0.39 vs the
        # march's 0.0 across a whole shadow at nomination 0.25, where
        # the exit lands 1-2 coarse-grid px past the surface and drags
        # the midpoint with it). For SHALLOW minima (a blocker whose top
        # grazes the trace plane, d ~ 0 along the crossing) the arg-min
        # position within the flat span is arbitrary and the descending
        # true ray is lowest midway — probe the span middle there.
        # Probing slightly FORWARD of the arg-min (toward the exit) is
        # still better than the arg-min itself at fine grids — the ray
        # descends, so a small step gains depth in z — but the step must
        # be capped in WORLD units: at coarse grids the half-span is
        # several world units and overshoots the footprint. major/
        # render_scale converts ray fractions to world units in xy.
        fwd = jnp.minimum(
            (exit_frac - k_frac) * 0.5,
            1.5 / (major * sec),  # 1.5 world units as a ray fraction
        )
        t_star = jnp.where(min_d < -1.0, k_frac + fwd,
                           (k_frac + exit_frac) * 0.5)
        vis = jnp.ones(min_d.shape, jnp.float32)
        if quality.scan_refine_samples == 1:
            candidates = (t_star,)
        elif quality.scan_refine_samples == 2:
            candidates = (t_star, exit_frac)
        else:
            # The shallow-graze branch of t_star IS the midpoint — a
            # third unconditional midpoint would duplicate it there and
            # waste a full-res scene eval; probe the span ENTRY instead
            # (deep interiors get k+fwd ~ entry already, shallow ones
            # gain the entry the 2-sample set lacks).
            t_entry = jnp.where(min_d < -1.0, (k_frac + exit_frac) * 0.5,
                                k_frac)
            candidates = (t_star, t_entry, exit_frac)
    # Candidates along the blocker span: the depth-gated t_star covers
    # the 3D-deepest point; the exit covers near-edge contact (the ray
    # is lowest there); the unconditional midpoint (refine >= 3) covers
    # compound spans.
    for t in candidates:
        sz = lz[:, None, None] + (pz_lift - lz[:, None, None]) * t
        if use_cols:
            # Elementwise column reconstruction at the candidate:
            # (t*, b*) rode the walk from the nominated blocker's
            # column; f_min is the running FOOTPRINT minimum along the
            # ray (exact where the trace plane crosses the interval;
            # strictly better than the carried flatland min when the
            # plane sits above a short blocker, whose footprint still
            # goes negative inside). Pass-over rays get d = z - t*
            # EXACTLY — the 3D behavior the refine exists to restore —
            # with ZERO scattered field samples.
            d_i = reconstruct_profile(tb_star[0], tb_star[1], tb_star[2],
                                      sz)
        else:
            sx = lx_w + (px_x - lx_w) * t
            sy = ly_w + (px_y - ly_w) * t
            d_i = scene_sample_p(scene, sx, sy, sz)
        u_i = jnp.maximum((1.0 - t) * major * sec, 0.0)
        radius_i = jnp.minimum(growth * u_i + MIN_CONE_RADIUS, max_radius)
        vis_i = (d_i + HACK_DISTANCE_OFFSET) / radius_i
        vis = jnp.minimum(vis, jnp.where(has_blocker, vis_i, 1.0))
    if candidates:
        # Compound-umbra guard: with MULTIPLE occluders on one ray, the
        # arg-min nominates only one — candidates can miss the other and
        # the refine then UNDOES a correct flatland block (measured:
        # p99 error 1.0 on a 3-occluder scene, tools/approx_artifacts.py).
        # Where the 3D ray at the nominated blocker sits at-or-below the
        # trace plane, the flatland block provably applies for
        # ground-standing occluders (the 2.5D scene model) — clamp by
        # the flatland visibility there. Rays passing OVER short
        # obstructions are above the plane at their blocker and keep
        # their refined (lit) value.
        # "Low" at the blocker ENTRY (k) or at its EXIT: both points sit
        # on/within ~1 unit of a blocker whose top reaches the trace
        # plane, so a ray at-or-below the plane there is inside a
        # ground-standing blocker's volume (the stored exit is the last
        # near-surface sample — its xy is on the blocker footprint even
        # when the flatland ray only grazes the top band and d never
        # goes negative, the case a strict entry-only test missed).
        ray_z_at_k = lz[:, None, None] + (
            pz_lift - lz[:, None, None]
        ) * k_frac
        ray_z_at_exit = lz[:, None, None] + (
            pz_lift - lz[:, None, None]
        ) * exit_frac
        # The exit-low case only fires on REAL interiors (min_d well
        # below 0): at coarse nomination grids the smeared exit position
        # would otherwise clamp penumbra pixels to the flatland cone
        # value and over-darken soft edges (measured on the 'tall'
        # test scene at nomination 0.25).
        low_ray = (ray_z_at_k <= trace_z + 0.5) | (
            (ray_z_at_exit <= trace_z + 0.5) & (min_d < -0.5))
        u0 = jnp.maximum((1.0 - k_frac) * major * sec, 0.0)
        radius0 = jnp.minimum(growth * u0 + MIN_CONE_RADIUS, max_radius)
        flat_vis = jnp.minimum(
            (min_d + HACK_DISTANCE_OFFSET) / radius0, 1.0
        )
        vis = jnp.where(
            has_blocker & low_ray, jnp.minimum(vis, flat_vis), vis
        )
    final = (
        jnp.clip(
            jnp.clip(vis - FULLY_SHADOWED_THRESHOLD, 0.0, 1.0)
            / (UNSHADOWED_THRESHOLD - FULLY_SHADOWED_THRESHOLD),
            0.0,
            1.0,
        )
        ** quality.occlusion_to_opacity_power
    )
    return final


def _upsample_nominated(min_d, k_frac, exit_frac, halvings: int,
                        extras=(), fmin=None):
    """Upsample the three nominated fields to the readout grid. f16
    keeps the HBM cost of the extra materialization at half (fractions
    keep ~0.05% of ray length, min_d ~0.06 world units). The no-blocker
    sentinel is clamped to 8192 first so bilinear edges don't smear 1e9
    into real distances; real scene distances are <= maximum_distance
    (~128), so "bilinear min_d < 4096" IS the 2x2 majority vote on the
    blocker mask. The FRACTIONS are upsampled as a NORMALIZED
    CONVOLUTION weighted by that mask: a plain bilinear would blend the
    no-blocker pixels' meaningless fraction values (0 after the k-offset
    round-trip for on-screen lights) into real ones at mask edges,
    decaying the refine sample toward the light along umbra boundaries.
    `extras` (the ColumnField (h_top, h_bot) argmin payloads) upsample
    NEAREST-NEIGHBOR, not bilinear: heights are per-blocker constants,
    and a lerp between two different blockers' tops invents a phantom
    intermediate blocker that refined rays "pass over" (measured: the
    nomination upsample was the whole cols-vs-exact error, mean 0.0087
    -> 0.0013 with nomination off). Coarse pixels with NO nomination
    fill with a huge interval (t=+4096, b=-4096): the reconstruction
    then returns the flatland min unchanged — "no blocker info, don't
    lighten".

    Returns (min_d, k_frac, exit_frac, has_blocker, extras) at
    2^halvings x the input resolution."""
    nom_mask = min_d < 4096.0
    min_d = jnp.minimum(min_d, 8192.0)
    # Fractions are stored f16 as COMPLEMENTS (1 - frac): for a far
    # off-screen light (directional pseudo-center, ray length ~9000
    # world units) the interesting fractions sit near 1.0 where f16
    # spacing is 2^-11 (~4.4 world units of blocker-position error —
    # the same magnitude the k_off trick in _bidirectional_scan
    # eliminates); near 0 the spacing is fine-grained, so the
    # complement keeps sub-unit precision exactly where it matters.
    k_c = jnp.where(nom_mask, 1.0 - k_frac, 0.0).astype(jnp.float16)
    e_c = jnp.where(nom_mask, 1.0 - exit_frac, 0.0).astype(jnp.float16)
    wgt = nom_mask.astype(jnp.float16)
    min_d = min_d.astype(jnp.float16)
    # (h_top, h_bot) neutral fills: a huge interval keeps the
    # reconstruction at its footprint term alone.
    _EX_FILL = (4096.0, -4096.0)
    ex_c = [jnp.where(nom_mask, e, fill).astype(jnp.float16)
            for e, fill in zip(extras, _EX_FILL)]
    # Mask-normalized footprint minimum (the reconstruction's f term —
    # a smooth distance field, so bilinear; the _BIG sentinel on
    # no-blocker rays would smear into real values otherwise).
    fm_c = (None if fmin is None
            else jnp.where(nom_mask, jnp.minimum(fmin, 4096.0),
                           0.0).astype(jnp.float16))
    for _ in range(halvings):
        k_c = upsample2x_bilinear(k_c)
        e_c = upsample2x_bilinear(e_c)
        min_d = upsample2x_bilinear(min_d)
        wgt = upsample2x_bilinear(wgt)
        # EDGE-AWARE height upsample: bilinear where the coarse
        # neighborhood agrees (|bilinear - nearest| small => the 2x2
        # support is one blocker — smooths the silhouette quantization
        # that made the refine grid-sensitive: the halfres extra-family
        # frame diverged 2.8% of pixels > 2 LSB under plain NN, 0.9%
        # with this, vs 0.09% for the exact refine), nearest across
        # blocker boundaries (a lerp between two blockers' tops invents
        # a phantom intermediate blocker — the original NN rationale).
        ex_new = []
        for e in ex_c:
            nn = jnp.repeat(jnp.repeat(e, 2, axis=-2), 2, axis=-1)
            bi = upsample2x_bilinear(e)
            ex_new.append(jnp.where(jnp.abs(bi - nn) < 2.0, bi, nn))
        ex_c = ex_new
        if fm_c is not None:
            fm_c = upsample2x_bilinear(fm_c)
    min_d = min_d.astype(jnp.float32)
    has_blocker = min_d < 4096.0
    wgt = jnp.maximum(wgt.astype(jnp.float32), 1e-3)
    k_frac = jnp.clip(1.0 - k_c.astype(jnp.float32) / wgt, 0.0, 1.0)
    exit_frac = jnp.clip(1.0 - e_c.astype(jnp.float32) / wgt, 0.0, 1.0)
    ex_out = tuple(e.astype(jnp.float32) for e in ex_c)
    if fm_c is not None:
        ex_out = (fm_c.astype(jnp.float32) / wgt,) + ex_out
    return min_d, k_frac, exit_frac, has_blocker, ex_out


def resize_visibility(vis, target_hw):
    """Resize (L, h, w) visibility to (L, H, W): identity when shapes
    match, the fast bf16 2x upsample for exact halvings, jax.image
    linear otherwise. The canonical dispatch shared by
    scan_cone_visibility's tail and the fused-scan consumers in
    scenes.py — keep alignment conventions in ONE place."""
    th, tw = target_hw
    if vis.shape[1:] == (th, tw):
        return vis
    if (vis.shape[1] * 2, vis.shape[2] * 2) == (th, tw):
        return upsample2x_bilinear(vis.astype(jnp.bfloat16))
    return jax.image.resize(vis, (vis.shape[0], th, tw), "linear")


def downsample2x_linear(x, axis):
    """Exact-2x linear-antialiased downsample along `axis`, numerically
    identical to jax.image.resize(..., "linear") for even dims (interior
    kernel [1/8, 3/8, 3/8, 1/8]; edge kernels renormalized [3,3,1]/7 —
    verified to float rounding). Built from static slices/concats so
    GSPMD keeps a sharded axis shard-local (halo via collective-permute)
    instead of the resize dot_general's plane all-gather
    (PARALLEL.md round-4 inventory)."""
    n = x.shape[axis]
    m = n // 2
    # Even/odd row split via a pair reshape: shard-local when the shard
    # size is even (a stride-2 slice on a sharded axis lowers to
    # all-to-all instead — measured 26 of them on the 8-device frame).
    shape = x.shape[:axis] + (m, 2) + x.shape[axis + 1:]
    pairs = x.reshape(shape)
    e = jax.lax.index_in_dim(pairs, 0, axis=axis + 1, keepdims=False)
    o = jax.lax.index_in_dim(pairs, 1, axis=axis + 1, keepdims=False)

    def sl(v, a, b):
        return jax.lax.slice_in_dim(v, a, b, axis=axis)

    om1 = jnp.concatenate([sl(o, 0, 1), sl(o, 0, m - 1)], axis=axis)
    ep1 = jnp.concatenate([sl(e, 1, m), sl(e, m - 1, m)], axis=axis)
    s = 0.125 * om1 + 0.375 * e + 0.375 * o + 0.125 * ep1
    # Edge kernels renormalize the clipped taps ([3,3,1]/7), matching
    # jax.image.resize exactly.
    first = (3.0 * sl(e, 0, 1) + 3.0 * sl(o, 0, 1) + sl(e, 1, 2)) / 7.0
    last = (sl(o, m - 2, m - 1) + 3.0 * sl(e, m - 1, m)
            + 3.0 * sl(o, m - 1, m)) / 7.0
    return jnp.concatenate(
        [first, sl(s, 1, m - 1), last], axis=axis)


def upsample2x_bilinear(v):
    """Elementwise bilinear 2x upsample over the last two axes (faster
    than jax.image.resize for the fixed 2x case; used by the shadow-scale
    path)."""
    def axis_up(x, axis):
        n = x.shape[axis]
        first = jax.lax.slice_in_dim(x, 0, 1, axis=axis)
        last = jax.lax.slice_in_dim(x, n - 1, n, axis=axis)
        lo = jnp.concatenate([first, x], axis=axis)
        hi = jnp.concatenate([x, last], axis=axis)
        a = 0.75 * x + 0.25 * jax.lax.slice_in_dim(lo, 0, n, axis=axis)
        b = 0.75 * x + 0.25 * jax.lax.slice_in_dim(hi, 1, n + 1, axis=axis)
        stacked = jnp.stack([a, b], axis=axis + 1)
        new_shape = list(x.shape)
        new_shape[axis] = 2 * n
        return stacked.reshape(new_shape)

    return axis_up(axis_up(v, v.ndim - 2), v.ndim - 1)


# Convenience jitted alias: interactive callers and tests hit ONE
# whole-graph compile (persistent-compile-cache eligible) instead of
# hundreds of per-op eager compiles. Production frames trace
# scan_visibility inline inside their own jit and don't need this.
scan_visibility_jit = jax.jit(
    scan_visibility,
    static_argnames=("height", "width", "quality", "render_scale"),
)


def scan_cone_visibility(
    scene,
    gbuffer,
    light_position,  # (L, 3) world (possibly pseudo — directional)
    light_radius,  # (L,)
    light_ramp_length,  # (L,)
    quality: QualitySettings,
    max_trace_distance=None,  # (L,) or None
    trace_z=None,
    self_occlusion_lift=1.6,
    upsample: bool = True,
    light_active=None,  # (L,) 0/1 pad mask for the default trace plane
):
    """Shadow-scale-aware scan visibility over a G-buffer -> (L, H, W).

    Shared dispatch for every light family on the scan path: computes the
    normal-lifted shading endpoints (SphereLightCore.fxh:151 + the 2.5D
    screen->world y reconstruction, LightCommon.fxh:119), runs the scan
    at quality.shadow_scale resolution, and upsamples in bf16.

    `self_occlusion_lift` is the family's SELF_OCCLUSION_HACK constant —
    1.6 for sphere lights (SphereLightCore.fxh:151), 1.5 for
    directional/line (LineLightCore.fxh:10) — so the scan shades the same
    endpoint as the march it replaces. A MULTI-FAMILY fused call (one
    scan pass carrying several families' anchors on the L axis — the
    scan's sequential column cost is per-pass, so extra lights are
    nearly free) passes an (L,) array of per-light lifts.

    `upsample=False` returns the scan-resolution (L, sh, sw) visibility
    (fused callers slice per family and upsample to each consumer's
    resolution themselves).
    """
    h, w = gbuffer.shape
    ss = quality.shadow_scale
    world_off = (
        gbuffer.pixel_origin / gbuffer.render_scale
        if gbuffer.pixel_origin is not None else None
    )
    lift = jnp.asarray(self_occlusion_lift, jnp.float32)

    def _resize(arr, sh, sw, channels=0):
        # arr is (..., H, W) when channels == 0, (..., H, W, C) when
        # channels == C; leading dims (the per-light axis of a fused
        # multi-family call) resize as identity.
        spatial_at = arr.ndim - 2 - (1 if channels else 0)
        ah, aw = arr.shape[spatial_at], arr.shape[spatial_at + 1]
        if (ah, aw) == (sh * 2, sw * 2):
            # Exact halving: the shard-local kernel (== jax.image.resize
            # to float rounding) so a row-sharded plane downsamples
            # without the resize dot_general's all-gather.
            return downsample2x_linear(
                downsample2x_linear(arr, spatial_at), spatial_at + 1)
        shape = (arr.shape[:spatial_at] + (sh, sw)
                 + ((channels,) if channels else ()))
        return jax.image.resize(arr, shape, "linear")

    if ss == 0.5 and h % 2 == 0 and w % 2 == 0:
        sh, sw = h // 2, w // 2
    elif ss != 1.0:
        sh, sw = max(int(h * ss), 8), max(int(w * ss), 8)
        if sh * w != sw * h:
            # Anisotropic rounding (min-8 clamp or odd dims) would give
            # the two axes different scales — the scan's ray geometry
            # (dx/dy slopes, sector select, single render_scale) assumes
            # square pixels. Fall back to full resolution.
            sh, sw = h, w
    else:
        sh, sw = h, w
    # Lift-then-resize == resize-then-lift (both linear). For a SCALAR
    # lift, lifting first is cheaper (3 planes through the resize: z +
    # 2 offsets, vs z + 3 normals + relative_y). For a fused multi-
    # family ARRAY lift, lifting first would materialize 3L full-res
    # planes (~300 MB of HBM traffic for a 12-lane 1080p call) — resize
    # the 5 shared G-buffer planes once and lift per light at scan
    # resolution instead.
    if lift.ndim == 0:
        lifted_z = gbuffer.z + lift * gbuffer.normal[..., 2]
        off_x = lift * gbuffer.normal[..., 0]
        off_y = lift * gbuffer.normal[..., 1] + gbuffer.relative_y
        offset_xy = jnp.stack([off_x, off_y], axis=-1)
        if (sh, sw) != (h, w):
            pixel_z = _resize(lifted_z, sh, sw)
            off = _resize(offset_xy, sh, sw, channels=2)
        else:
            pixel_z, off = lifted_z, offset_xy
    else:
        if (sh, sw) != (h, w):
            z_s = _resize(gbuffer.z, sh, sw)
            n_s = _resize(gbuffer.normal, sh, sw, channels=3)
            ry_s = _resize(gbuffer.relative_y, sh, sw)
        else:
            z_s, n_s, ry_s = gbuffer.z, gbuffer.normal, gbuffer.relative_y
        li = lift[:, None, None]
        pixel_z = z_s[None] + li * n_s[None, ..., 2]
        off_x = li * n_s[None, ..., 0]
        off_y = li * n_s[None, ..., 1] + ry_s[None]
        off = jnp.stack([off_x, off_y], axis=-1)
    vis = scan_visibility(
        scene, sh, sw, light_position, light_radius,
        light_ramp_length, quality,
        render_scale=gbuffer.render_scale * (sh / h if sh != h else 1.0),
        pixel_z=pixel_z, pixel_offset_xy=off,
        max_trace_distance=max_trace_distance, trace_z=trace_z,
        world_offset=world_off, light_active=light_active,
    )
    if not upsample:
        return vis
    return resize_visibility(vis, (h, w))
