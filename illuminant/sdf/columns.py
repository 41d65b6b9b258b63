"""Column-interval decomposition of a voxel SDF: scattered queries from
2D maps instead of the 3D volume.

A scattered trilinear sample reads 8 taps of the (S, H, W) volume; the
dense interpolation-matrix form of it costs N * S*H*W MACs. The maps
below cut both to a 2D problem.

The reference's voxel content is Z-EXTRUDED or convex: obstructions
are box/cylinder/octagon prisms, spheroids and ellipsoids
(LightObstruction.cs:10-16), height volumes are extruded polygons
(HeightVolume.cs). Every column (x, y) of such a field is occupied on
a SINGLE z-interval [b, t], and for exact z-prisms the whole 3D SDF
factors through three 2D maps:

    f(x, y)  = footprint distance  = min_z d(x, y, z)
    t(x, y)  = top of the occupied/flat interval
    b(x, y)  = bottom of the interval

    d(x, y, z) = min(max(f, dz), 0) + hypot(max(f, 0), max(dz, 0)),
    dz = max(b - z, z - t)                       (the prism SDF)

The maps INVERT from three slices of the stored profile (exact for
prisms, derivation in `build_column_maps`), so a generic loaded field
(DistanceField.cs:178-213 Save/Load content) decomposes without
knowing its scene. Scattered queries then cost N * 3*H*W MACs of
2D interpolation-matrix matmuls — 16x less than the 3D contraction
(S=16) — plus cheap elementwise reconstruction.

Approximation contract (bounded in tests/test_columns.py):
  * EXACT (to xy-bilinear of the maps) for z-extruded content:
    vertical boxes/cylinders/octagons, HeightVolume polygons.
  * MOSTLY CONSERVATIVE (d-underestimate) for shapes whose horizontal
    cross-section varies with z (ellipsoids, spheroids, rotated
    boxes): f is the equator footprint, so points above the narrowing
    top read a smaller d and shadows grow by <= the overhang. The
    empty-column arm inversion can OVERestimate near a narrowing top
    (measured p99 ~3.6 units on a 24x16x20 ellipsoid,
    tests/test_columns.py) — consumers are threshold/ratio-based
    (collision ~1 unit, cone radii >= 4), sized against that bound.
  * Multi-interval columns (stacked shapes with a z-gap) merge into
    one interval: the gap reads as occupied. Exact `sampling.sample`
    remains the oracle and the grid paths stay exact — ColumnField
    only changes SCATTERED queries.

Citations: the sampling this replaces is sampleDistanceFieldEx
(/root/reference/Illuminant/Shaders/DistanceFieldCommon.fxh:313-353);
consumers are the cone-trace refine (ConeTrace.fxh:51-71 semantics via
scan_shadows.py) and particle collision
(UpdateParticleSystemWithDistanceField.fx:29-147 via integrate.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.pytree import pytree_dataclass
from .volume import SdfVolume
from .sampling import _interp_rows, _deriv_rows, _clamped_axes


@pytree_dataclass
class ColumnField:
    """A voxel field plus its column-interval maps.

    Grid/separable queries route to the exact volume paths; scattered
    queries use the maps (see module docstring). flat_d/h_top/h_bot
    are (H, W) f32 in world units; h_* include config.z_offset.
    d_top/d_bot are the END-SLICE profile values — 1-Lipschitz clamps
    d(z) <= d(z_end) + |z - z_end| that bound the interval model's
    error on TWO-BAND columns (a neighbor shape at a different height
    whose flat band the single interval can't represent).
    """

    volume: SdfVolume
    flat_d: jnp.ndarray
    h_top: jnp.ndarray
    h_bot: jnp.ndarray
    d_top: jnp.ndarray
    d_bot: jnp.ndarray
    # Stacked (5, Hc, Wc) f32 pack of the five maps for SCATTERED
    # queries (collision), box-downsampled 2x from the full maps when
    # dims allow: the one-hot contraction's cost is N * Wc * 5Hc
    # MACs, so halving the map grid quarters the collision sampling
    # cost. Coarse cell centers align exactly with
    # the 2x2 fine-texel box centers (scale_c = scale / 2). The full
    # maps above stay for the scan's carried-refine images
    # (resample_map_to_grid — grid-shaped, cheap, full fidelity).
    maps_c: jnp.ndarray

    @property
    def config(self):
        return self.volume.config


def build_column_maps(volume: SdfVolume, coarse: int = 2) -> ColumnField:
    """Invert the three column maps from the voxel stack.

    `coarse`: downsample factor for the scattered-query map pack
    (`maps_c`) — 2 (default) box-averages 2x2 when dims are even,
    quartering the scattered contraction cost; 1 keeps full resolution
    (the accuracy oracle; tests pin the coarse error against it).

    For a z-prism with footprint SDF f over [b, t], the stored profile
    at a column is d(z) = min(max(f, dz), 0) + hypot(f+, dz+). Solving
    for t from the TOP slice (z1 = z of slice S-1, d1 = profile there):

      f <  0 (occupied column): d1 = z1 - t when z1 > t (else d1 < 0
              and t = z1 - d1 still holds within the interval up to
              the distance-to-side, which min() keeps conservative)
              -> t = z1 - d1.
      f >= 0 (empty column):    d1 = hypot(f, max(z1 - t, 0))
              -> t = z1 - sqrt(max(d1^2 - f^2, 0)).

    Both cases unify as t = z1 - sign(d1) * sqrt(relu(d1^2 - relu(f)^2))
    (for f < 0, relu(f) = 0 and the expression is z1 - d1). The bottom
    map mirrors it from slice 0. Elementwise over the stack — O(S*H*W),
    cheap enough to rebuild per frame after a dynamic-partition regen.
    """
    c = volume.config
    data = volume.data  # (S, H, W)
    f = jnp.min(data, axis=0)
    S = c.slice_count

    dz_slice = c.slice_z_size
    zs = (jnp.arange(S, dtype=jnp.float32) * dz_slice
          + c.z_offset)[:, None, None]
    big = jnp.float32(1e9)

    # OCCUPIED columns (f < 0): the interval ends are the profile's own
    # topmost/bottommost zero crossings, lerped between slices — exact
    # for the z-interpolated field and immune to NEIGHBOR CONTAMINATION
    # (d at slices above one shape's top can read a taller shape 20 px
    # away; any inversion of those d values overestimates t — measured
    # -7.5 vs exact +5.2 on overlapping-footprint columns before this).
    d_lo, d_hi = data[:-1], data[1:]
    denom = d_lo - d_hi
    frac = d_lo / jnp.where(jnp.abs(denom) > 1e-9, denom, 1e-9)
    cross_z = zs[:-1] + dz_slice * frac
    up = (d_lo < 0.0) & (d_hi >= 0.0)
    dn = (d_lo >= 0.0) & (d_hi < 0.0)
    t_occ = jnp.max(jnp.where(up, cross_z, -big), axis=0)
    b_occ = jnp.min(jnp.where(dn, cross_z, big), axis=0)
    # Content reaching past the end slices: extrapolate by the end
    # value (1-Lipschitz; queries are z-clamped to the end slices
    # anyway, so only the sign structure matters there).
    t_occ = jnp.where(data[-1] < 0.0, zs[-1, 0, 0] - data[-1], t_occ)
    b_occ = jnp.where(data[0] < 0.0, zs[0, 0, 0] + data[0], b_occ)
    # No crossing found at all (single-slice blip): collapse to the
    # argmin slice height.
    z_amin = jnp.take(zs[:, 0, 0], jnp.argmin(data, axis=0))
    t_occ = jnp.where(t_occ <= -big, z_amin, t_occ)
    b_occ = jnp.where(b_occ >= big, z_amin, b_occ)

    # EMPTY columns (f >= 0): the profile is flat (= f) while z is
    # inside the nearby content's interval and grows hypot-like
    # outside. Invert the arm ONLY at the first slice after the flat
    # knee (the least neighbor-contaminated sample): t from
    # d = hypot(f, z - t) at that slice.
    f_pos2 = jnp.square(jnp.maximum(f, 0.0))[None]
    arm = jnp.sqrt(jnp.maximum(jnp.square(data) - f_pos2, 0.0))
    tol = 0.26 * dz_slice
    flat = data <= (f[None] + tol)
    rise = flat[:-1] & ~flat[1:]  # knee between s and s+1
    fall = ~flat[:-1] & flat[1:]
    t_emp = jnp.max(jnp.where(rise, zs[1:] - arm[1:], -big), axis=0)
    b_emp = jnp.min(jnp.where(fall, zs[:-1] + arm[:-1], big), axis=0)
    # Flat to the volume ends -> the interval extends past them.
    t_emp = jnp.where(flat[-1], zs[-1, 0, 0], t_emp)
    b_emp = jnp.where(flat[0], zs[0, 0, 0], b_emp)
    t_emp = jnp.where(t_emp <= -big, z_amin, t_emp)
    b_emp = jnp.where(b_emp >= big, z_amin, b_emp)

    occ = f < 0.0
    t = jnp.where(occ, t_occ, t_emp)
    b = jnp.where(occ, b_occ, b_emp)
    # An interval that inverts inverted (noise) collapses to its mid.
    mid = 0.5 * (t + b)
    t = jnp.maximum(t, mid)
    b = jnp.minimum(b, mid)
    stack = jnp.stack([f, t, b, data[-1], data[0]], axis=0)  # (5, H, W)
    H, W = f.shape
    if coarse == 2 and H % 2 == 0 and W % 2 == 0:
        maps_c = stack.reshape(5, H // 2, 2, W // 2, 2).mean((2, 4))
    else:
        maps_c = stack
    return ColumnField(volume=volume, flat_d=f, h_top=t, h_bot=b,
                       d_top=data[-1], d_bot=data[0], maps_c=maps_c)


def _reconstruct(f, t, b, z, want_grad: bool, gfx=None, gfy=None):
    """Prism SDF from the maps at world z. Returns d or (d, gx, gy, gz);
    gfx/gfy are the footprint-map world-space gradients (side-contact
    normals); top/bottom contact contributes the z component."""
    below = b - z
    above = z - t
    dz = jnp.maximum(below, above)
    f_pos = jnp.maximum(f, 0.0)
    dz_pos = jnp.maximum(dz, 0.0)
    outside = jnp.sqrt(f_pos * f_pos + dz_pos * dz_pos)
    d = jnp.minimum(jnp.maximum(f, dz), 0.0) + outside
    if not want_grad:
        return d
    # Inside: step toward the closer face (footprint side vs z cap).
    # Outside: the normalized (f+, dz+) combination.
    zsign = jnp.where(above > below, 1.0, -1.0)
    inv = 1.0 / jnp.maximum(outside, 1e-9)
    out_mask = (f > 0.0) | (dz > 0.0)
    side_w = jnp.where(out_mask, f_pos * inv, jnp.where(f >= dz, 1.0, 0.0))
    cap_w = jnp.where(out_mask, dz_pos * inv, jnp.where(f >= dz, 0.0, 1.0))
    gx = side_w * gfx
    gy = side_w * gfy
    gz = cap_w * zsign
    return d, gx, gy, gz


def reconstruct_profile(f, t, b, z):
    """Elementwise column-prism SDF from ALREADY-SAMPLED map values —
    the scan-refine fast path (scan_shadows carries (t, b) at the
    nominated blocker through the column walk and uses the flatland
    min as f; the 3D refine then needs ZERO scattered samples)."""
    return _reconstruct(f, t, b, z, False)


def resample_map_to_grid(field: ColumnField, map2d, nh: int, nw: int,
                         nscale, world_offset=None):
    """Bilinear-resample a column map onto an (nh, nw) PIXEL-CENTER grid
    (pixel centers at (i + 0.5)/nscale [+ world_offset] world units) —
    two small interpolation-row matmuls, grid-shaped, no gathers.
    Matches `sampling.grid_stack`'s texel conventions (clip, then
    scale - 0.5)."""
    from .sampling import _interp_rows

    c = field.config
    H, W = map2d.shape
    xs = (jnp.arange(nw, dtype=jnp.float32) + 0.5) / nscale
    ys = (jnp.arange(nh, dtype=jnp.float32) + 0.5) / nscale
    if world_offset is not None:
        xs = xs + world_offset[0]
        ys = ys + world_offset[1]
    cx = jnp.clip(xs, 0.0, float(c.virtual_width))
    cy = jnp.clip(ys, 0.0, float(c.virtual_height))
    bx = _interp_rows(cx * c.scale_x - 0.5, W, jnp.float32)   # (nw, W)
    by = _interp_rows(cy * c.scale_y - 0.5, H, jnp.float32)   # (nh, H)
    return by @ map2d @ bx.T


# Chunk size for the 2D map sampling (mirrors sampling._INTERP_CHUNK:
# bounds the (chunk, 3H) intermediate while keeping the matmul large).
_MAP_CHUNK = 1 << 15


def _map_coords(field: ColumnField, pos_flat):
    """Shared coordinate head: world -> COARSE-map texel coords plus the
    clamp/AABB terms. Coarse cell centers align with the 2x2 fine-box
    centers, so scale_c = scale * (Wc / slice_width) and
    t_c = (t_fine + 0.5) * ratio - 0.5."""
    c = field.config
    _, Hc, Wc = field.maps_c.shape
    rx = Wc / float(c.slice_width)
    ry = Hc / float(c.slice_height)
    px, py, pz = pos_flat[:, 0], pos_flat[:, 1], pos_flat[:, 2]
    tx, ty, _sp, (ux, uy, uz), (in_x, in_y, _) = _clamped_axes(
        field.volume, px, py, pz)
    tx = (tx + 0.5) * rx - 0.5
    ty = (ty + 0.5) * ry - 0.5
    return (tx, ty, pz, (ux, uy, uz), (in_x, in_y),
            (c.scale_x * rx, c.scale_y * ry))


def _finish(field: ColumnField, coords, f, t, b, d_top, d_bot,
            want_grad: bool, gfx=None, gfy=None):
    """Shared reconstruction tail: saturated-z reconstruct + Lipschitz
    end-clamps + out-of-volume distance (the reference sampler's exact
    semantics: sampleDistanceFieldEx clamps, samples, then adds;
    fxh:320-321; the z-lerp additionally saturates at the END SLICES,
    so d(z) is constant past them — reconstructing at the raw z would
    double-count the vertical out-of-volume term). `gfx`/`gfy` are the
    footprint-map world-space gradients from either sampling backend."""
    c = field.config
    _tx, _ty, pz, (ux, uy, uz), (in_x, in_y), _scales = coords
    z_lo = c.z_offset
    z_hi = c.z_offset + min((c.slice_count - 1) * c.slice_z_size,
                            1e30)
    pzc = jnp.clip(pz - uz, z_lo, z_hi)
    dist = jnp.sqrt(ux * ux + uy * uy + uz * uz)
    # 1-Lipschitz clamps from the end-slice profile values: bound the
    # single-interval model on two-band columns (see ColumnField).
    lip = jnp.minimum(d_top + (z_hi - pzc), d_bot + (pzc - z_lo))
    if not want_grad:
        d = _reconstruct(f, t, b, pzc, False)
        return jnp.minimum(d, lip) + dist

    gfx = jnp.where(in_x, gfx, 0.0)
    gfy = jnp.where(in_y, gfy, 0.0)
    d, gx, gy, gz = _reconstruct(f, t, b, pzc, True, gfx, gfy)
    # When a Lipschitz end-clamp wins, the nearest feature is toward
    # that end: the gradient is +-z (the xy variation of the end-slice
    # maps is second-order for the bounce normal's purposes).
    top_wins = (d_top + (z_hi - pzc)) <= (d_bot + (pzc - z_lo))
    clamped = lip < d
    d = jnp.minimum(d, lip)
    gx = jnp.where(clamped, 0.0, gx)
    gy = jnp.where(clamped, 0.0, gy)
    # d = d_top + (z_hi - z) has dd/dz = -1 (feature above, push down);
    # the bottom clamp is +1.
    gz = jnp.where(clamped, jnp.where(top_wins, -1.0, 1.0), gz)
    safe = jnp.maximum(dist, 1e-9)
    gx = gx + jnp.where(dist > 0.0, ux / safe, 0.0)
    gy = gy + jnp.where(dist > 0.0, uy / safe, 0.0)
    gz = gz + jnp.where(dist > 0.0, uz / safe, 0.0)
    return d + dist, gx, gy, gz


def _map_core(field: ColumnField, packed, pos_flat, want_grad: bool):
    """Sample the five maps + optional footprint gradient at a flat
    (N, 3) batch via interpolation-row matmuls, then reconstruct.

    `packed`: (Wc, 5*Hc) bf16 operand from `_packed_maps` (the COARSE
    map pack), computed once outside the chunk loop."""
    _, Hc, Wc = field.maps_c.shape
    coords = _map_coords(field, pos_flat)
    tx, ty = coords[0], coords[1]
    sx_c, sy_c = coords[5]

    bx = _interp_rows(tx, Wc, jnp.bfloat16)                   # (N, Wc)
    t1 = jax.lax.dot(bx, packed)                              # (N, 5Hc)
    t1 = t1.reshape(-1, 5, Hc)
    by = _interp_rows(ty, Hc, jnp.float32)                    # (N, Hc)
    maps = jnp.einsum("nch,nh->nc", t1, by,
                      preferred_element_type=jnp.float32)
    f, t, b = maps[:, 0], maps[:, 1], maps[:, 2]
    d_top, d_bot = maps[:, 3], maps[:, 4]
    if not want_grad:
        return _finish(field, coords, f, t, b, d_top, d_bot, False)

    dbx = _deriv_rows(tx, Wc, jnp.bfloat16)
    t1x = jax.lax.dot(dbx, packed).reshape(-1, 5, Hc)
    gfx = jnp.einsum("nh,nh->n", t1x[:, 0], by,
                     preferred_element_type=jnp.float32) * sx_c
    dby = _deriv_rows(ty, Hc, jnp.float32)
    gfy = jnp.einsum("nh,nh->n", t1[:, 0], dby,
                     preferred_element_type=jnp.float32) * sy_c
    return _finish(field, coords, f, t, b, d_top, d_bot, True, gfx, gfy)


def _packed_maps(field: ColumnField):
    """(Wc, 5*Hc) bf16 matmul operand from the coarse pack. bf16
    relative error on the HEIGHT maps is ~2^-8 * |h| <= 0.25 world
    units at depth 64 — below the voxel z-lerp's own reconstruction
    error."""
    n, Hc, Wc = field.maps_c.shape
    return field.maps_c.reshape(n * Hc, Wc).T.astype(jnp.bfloat16)


def _chunked_maps(field: ColumnField, pos_flat, want_grad: bool):
    n = pos_flat.shape[0]
    packed = _packed_maps(field)
    if n <= _MAP_CHUNK:
        return _map_core(field, packed, pos_flat, want_grad)
    pad = (-n) % _MAP_CHUNK
    p = jnp.pad(pos_flat, ((0, pad), (0, 0)))
    p = p.reshape(-1, _MAP_CHUNK, 3)
    out = jax.lax.map(
        lambda q: _map_core(field, packed, q, want_grad), p)
    if want_grad:
        return tuple(o.reshape(-1)[:n] for o in out)
    return out.reshape(-1)[:n]


def sample_columns(field: ColumnField, position):
    """Column-reconstruction sample at world positions (..., 3)."""
    shape = position.shape[:-1]
    d = _chunked_maps(field, position.reshape(-1, 3), False)
    return d.reshape(shape)


def sample_columns_grad(field: ColumnField, position):
    """Sample + world-space gradient (the collision fast normal)."""
    shape = position.shape[:-1]
    d, gx, gy, gz = _chunked_maps(field, position.reshape(-1, 3), True)
    g = jnp.stack([gx, gy, gz], axis=-1)
    return d.reshape(shape), g.reshape(shape + (3,))
