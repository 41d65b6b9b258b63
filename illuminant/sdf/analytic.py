"""Analytic SDF scene: gather-free distance queries.

The reference rasterizes obstructions into a 3D distance texture because GPU
texture fetches are nearly free (SDF/DistanceField.cs + DistanceFunction.fx).
Here the primary path evaluates the analytic obstruction SDFs (ops/sdf_primitives, the same
formulas the rasterizer used) directly at every query point. The voxel
volume (volume.py/sampling.py) remains for polygonal height volumes,
precomputed/loaded fields, and reference-parity tests.

Obstructions are grouped BY TYPE at pack time (host side knows the types),
so a scene with only boxes pays only the box formula — the analog of the
reference's one-instanced-draw-per-type (LightingRenderer.DistanceField.cs:
347-399), which existed for the same reason.

Every query is exact (no voxel quantization, no slice interpolation, no
max-valid-z cap) — shadows and collisions from the analytic path are
sharper than the reference's rasterized-texture results at equal settings.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core.platform import platform_choice
from ..core.pytree import pytree_dataclass, static_field
from ..ops import sdf_primitives as sp

_EVALUATORS = {
    sp.TYPE_ELLIPSOID: sp.sd_ellipsoid,
    sp.TYPE_BOX: sp.sd_box,
    sp.TYPE_CYLINDER: sp.sd_cylinder,
    sp.TYPE_SPHEROID: sp.sd_spheroid,
    sp.TYPE_OCTAGON: sp.sd_octagon,
}

_FAR = 1e9


@pytree_dataclass
class AnalyticScene:
    """Type-grouped obstruction SoA.

    groups: tuple of (type_id, has_rotation) static descriptors aligned
    with the centers/sizes/rotations tuples. Empty scene -> distance
    saturates at `maximum_distance` (the no-field behavior of
    sampleDistanceField, DistanceFieldCommon.fxh:355-364).
    """

    centers: Tuple[jnp.ndarray, ...]
    sizes: Tuple[jnp.ndarray, ...]
    rotations: Tuple[jnp.ndarray, ...]
    polygons: object = None  # Optional[sdf.height_volume.HeightVolumes]
    group_types: Tuple[int, ...] = static_field(default=())
    group_rotated: Tuple[bool, ...] = static_field(default=())
    maximum_distance: float = static_field(default=128.0)
    # Live obstruction count per group (excluding pad slots). Empty tuple
    # means "all slots" (back-compat).
    group_counts: Tuple[int, ...] = static_field(default=())

    # Above this many total obstructions the per-obstruction python unroll
    # stops paying (graph size) and the vectorized group path takes over.
    _UNROLL_LIMIT = 64

    def _counts(self):
        if self.group_counts:
            return self.group_counts
        return tuple(int(c.shape[0]) for c in self.centers)

    def distance(self, position):
        """Scene distance at (..., 3) points -> (...,). Min over all
        obstructions (== the reference's MAX blend over encoded distances,
        fxh:264-270) and extruded height-volume polygons."""
        return self.distance_p(
            position[..., 0], position[..., 1], position[..., 2]
        )

    def distance_p(self, x, y, z):
        """Planar scene distance: x/y/z broadcastable component arrays ->
        distance of their broadcast shape. The fast path: unrolls over
        the (few) obstructions so XLA fuses the whole scene into ONE
        elementwise pass with no (..., n, 3) padded intermediates."""
        counts = self._counts()
        if sum(counts) > self._UNROLL_LIMIT:
            return self._distance_vectorized(x, y, z)
        shape = jnp.broadcast_shapes(jnp.shape(x), jnp.shape(y),
                                     jnp.shape(z))
        d = jnp.full(shape, self.maximum_distance, dtype=jnp.float32)
        for gi, type_id in enumerate(self.group_types):
            centers = self.centers[gi]  # (n, 3)
            sizes = self.sizes[gi]
            fn = sp.PLANAR_EVALUATORS[type_id]
            for i in range(counts[gi]):
                px = x - centers[i, 0]
                py = y - centers[i, 1]
                pz = z - centers[i, 2]
                if self.group_rotated[gi]:
                    q = self.rotations[gi]
                    px, py, pz = sp.rotate_by_quaternion_p(
                        px, py, pz, q[i, 0], q[i, 1], q[i, 2], q[i, 3]
                    )
                d = jnp.minimum(
                    d, fn(px, py, pz, sizes[i, 0], sizes[i, 1], sizes[i, 2])
                )
        if self.polygons is not None:
            from .height_volume import extruded_polygon_distance

            pos = jnp.stack(
                [jnp.broadcast_to(x, shape), jnp.broadcast_to(y, shape),
                 jnp.broadcast_to(z, shape)], axis=-1)
            d = jnp.minimum(
                d, extruded_polygon_distance(pos, self.polygons)
            )
        return d

    def _distance_vectorized(self, x, y, z):
        """Group-batched path for large obstruction counts."""
        shape = jnp.broadcast_shapes(jnp.shape(x), jnp.shape(y),
                                     jnp.shape(z))
        position = jnp.stack(
            [jnp.broadcast_to(x, shape), jnp.broadcast_to(y, shape),
             jnp.broadcast_to(z, shape)], axis=-1)
        d = jnp.full(shape, self.maximum_distance, dtype=jnp.float32)
        for gi, type_id in enumerate(self.group_types):
            centers = self.centers[gi]  # (n, 3)
            sizes = self.sizes[gi]
            p = position[..., None, :] - centers
            if self.group_rotated[gi]:
                p = sp.rotate_by_quaternion(p, self.rotations[gi])
            dg = _EVALUATORS[type_id](p, sizes)
            d = jnp.minimum(d, jnp.min(dg, axis=-1))
        if self.polygons is not None:
            from .height_volume import extruded_polygon_distance

            d = jnp.minimum(
                d, extruded_polygon_distance(position, self.polygons)
            )
        return d

    def normal_p(self, x, y, z):
        """Planar field gradient via reverse-mode AD -> (nx, ny, nz)."""
        import jax

        d, vjp = jax.vjp(self.distance_p, x, y, z)
        gx, gy, gz = vjp(jnp.ones_like(d))
        norm = jnp.sqrt(gx * gx + gy * gy + gz * gz)
        safe = jnp.maximum(norm, 1e-9)
        ok = norm > 1e-9
        return (jnp.where(ok, gx / safe, 0.0),
                jnp.where(ok, gy / safe, 0.0),
                jnp.where(ok, gz / safe, 0.0))

    def normal_fast_p(self, x, y, z):
        """Closed-form per-primitive normals selected by arg-min distance
        — ~1 eval cost vs the AD gradient's ~2x (the collision hot path's
        biggest line item). Polygon scenes fall back to AD."""
        if self.polygons is not None:
            return self.normal_p(x, y, z)
        counts = self._counts()
        if sum(counts) > self._UNROLL_LIMIT:
            # The per-obstruction unroll below recreates the graph-size
            # blowup the distance path's vectorized dispatch exists to
            # prevent — use central differences over the (bounded)
            # vectorized distance instead: 6 evals, still cheaper to
            # compile than hundreds of unrolled normal chains.
            eps = 0.05
            dxp = self._distance_vectorized(x + eps, y, z)
            dxn = self._distance_vectorized(x - eps, y, z)
            dyp = self._distance_vectorized(x, y + eps, z)
            dyn = self._distance_vectorized(x, y - eps, z)
            dzp = self._distance_vectorized(x, y, z + eps)
            dzn = self._distance_vectorized(x, y, z - eps)
            gx, gy, gz = dxp - dxn, dyp - dyn, dzp - dzn
            inv = 1.0 / jnp.sqrt(gx * gx + gy * gy + gz * gz + 1e-12)
            return gx * inv, gy * inv, gz * inv
        shape = jnp.broadcast_shapes(jnp.shape(x), jnp.shape(y),
                                     jnp.shape(z))
        best = jnp.full(shape, self.maximum_distance, dtype=jnp.float32)
        nx = jnp.zeros(shape, jnp.float32)
        ny = jnp.zeros(shape, jnp.float32)
        nz = jnp.zeros(shape, jnp.float32)
        for gi, type_id in enumerate(self.group_types):
            centers = self.centers[gi]
            sizes = self.sizes[gi]
            fn = sp.PLANAR_EVALUATORS[type_id]
            nfn = sp.PLANAR_NORMALS[type_id]
            for i in range(counts[gi]):
                px = x - centers[i, 0]
                py = y - centers[i, 1]
                pz = z - centers[i, 2]
                if self.group_rotated[gi]:
                    q = self.rotations[gi]
                    px, py, pz = sp.rotate_by_quaternion_p(
                        px, py, pz, q[i, 0], q[i, 1], q[i, 2], q[i, 3]
                    )
                d = fn(px, py, pz, sizes[i, 0], sizes[i, 1], sizes[i, 2])
                inx, iny, inz = nfn(px, py, pz, sizes[i, 0], sizes[i, 1],
                                    sizes[i, 2])
                if self.group_rotated[gi]:
                    inx, iny, inz = sp.rotate_by_quaternion_inverse_p(
                        inx, iny, inz, q[i, 0], q[i, 1], q[i, 2], q[i, 3]
                    )
                closer = d < best
                nx = jnp.where(closer, inx, nx)
                ny = jnp.where(closer, iny, ny)
                nz = jnp.where(closer, inz, nz)
                best = jnp.minimum(best, d)
        return nx, ny, nz

    def estimate_normal(self, position):
        """Exact field gradient via reverse-mode AD (~2 distance evals
        instead of the 4-tap tetrahedral stencil the texture path needs —
        the analytic field is differentiable, so VisualizeCommon.fxh's
        finite differences are unnecessary)."""
        nx, ny, nz = self.normal_p(
            position[..., 0], position[..., 1], position[..., 2]
        )
        return jnp.stack([nx, ny, nz], axis=-1)


def _is_identity_rotation(q) -> bool:
    return abs(q[0]) < 1e-9 and abs(q[1]) < 1e-9 and abs(q[2]) < 1e-9


def pack_scene(obstructions: List, maximum_distance: float = 128.0,
               group_capacity_round: int = 2,
               height_volumes: Optional[List] = None) -> AnalyticScene:
    """Group host LightObstruction-likes (.type/.center/.size/.rotation)
    by type. Group sizes round up to `group_capacity_round` (padded with
    far-away unit boxes) so small scene edits keep ARRAY shapes stable;
    note the live `group_counts` are static too (they size the unrolled
    python loops), so an edit that changes a live count within the same
    capacity still retraces — capacity rounding bounds how OFTEN, it
    does not eliminate retraces.
    `height_volumes`: optional list of sdf.height_volume.HeightVolume
    (obstruction-flagged ones contribute extruded polygon SDFs)."""
    by_type: Dict[int, list] = {}
    for o in obstructions:
        if o.type == sp.TYPE_NONE:
            continue
        # Negative ids are the voxel encoder's dynamic flag — the
        # analytic field evaluates the primitive itself (matching
        # evaluate_by_type's jnp.abs, sdf_primitives.py).
        tid = abs(o.type)
        if tid not in sp.PLANAR_EVALUATORS:
            raise ValueError(
                f"unknown obstruction type {o.type!r} (known: "
                f"{sorted(sp.PLANAR_EVALUATORS)})")
        by_type.setdefault(tid, []).append(o)

    centers, sizes, rotations = [], [], []
    group_types, group_rotated, group_counts = [], [], []
    for type_id in sorted(by_type):
        group = by_type[type_id]
        n = len(group)
        cap = -(-n // group_capacity_round) * group_capacity_round
        c = np.full((cap, 3), _FAR, np.float32)
        s = np.ones((cap, 3), np.float32)
        r = np.zeros((cap, 4), np.float32)
        r[:, 3] = 1.0
        rotated = False
        for i, o in enumerate(group):
            c[i] = o.center
            # Degenerate (zero) extents NaN-poison the vectorized
            # ellipsoid and the closed-form normals (division by r^2) —
            # clamp once here so every eval path is safe.
            s[i] = np.maximum(np.asarray(o.size, np.float32), 1e-6)
            r[i] = o.rotation
            rotated = rotated or not _is_identity_rotation(o.rotation)
        group_types.append(type_id)
        group_rotated.append(rotated)
        group_counts.append(n)
        centers.append(jnp.asarray(c))
        sizes.append(jnp.asarray(s))
        rotations.append(jnp.asarray(r))

    polygons = None
    if height_volumes:
        from .height_volume import pack_height_volumes

        obstructing = [v for v in height_volumes if v.is_obstruction]
        if obstructing:
            polygons = pack_height_volumes(obstructing)

    return AnalyticScene(
        centers=tuple(centers),
        sizes=tuple(sizes),
        rotations=tuple(rotations),
        polygons=polygons,
        group_types=tuple(group_types),
        group_rotated=tuple(group_rotated),
        maximum_distance=maximum_distance,
        group_counts=tuple(group_counts),
    )


# Scattered SdfVolume queries at or above this STATIC size may take the
# interpolation-matrix path (`sampling.sample_interp`) instead of the
# 8-tap gather (`sampling.sample`); smaller batches always gather.
_INTERP_MIN_POINTS = 1 << 14

# Which path large scattered batches take, per platform (True = the
# interpolation matrix). CPU: the dense interpolation matmuls are ~50x
# slower than the gather (a 256x256 voxel march took 417 s of the CPU
# test suite before this gate). GPU: the gather too — on an H100 it is
# 43x faster at 1M points and 101x at 4.1M, and the voxel frame with the
# exact refine runs 15.4 ms/frame gathering vs 63.4 through the matrix
# (PERF.md).
INTERP_BY_PLATFORM = {"cpu": False, "gpu": False}

# Dispatch mode: "auto" follows INTERP_BY_PLATFORM; "always"/"never"
# force one path (the CPU tests pin the interpolation path's semantics
# with "always").
_INTERP_DISPATCH = "auto"


def set_interp_dispatch(mode: str) -> str:
    """Set the scattered-voxel dispatch mode; returns the previous mode."""
    global _INTERP_DISPATCH
    if mode not in ("auto", "always", "never"):
        raise ValueError(f"unknown interp dispatch mode {mode!r}")
    prev = _INTERP_DISPATCH
    _INTERP_DISPATCH = mode
    return prev


class interp_dispatch:
    """Context manager: `with interp_dispatch("always"): ...`"""

    def __init__(self, mode: str):
        self.mode = mode

    def __enter__(self):
        self.prev = set_interp_dispatch(self.mode)

    def __exit__(self, *exc):
        set_interp_dispatch(self.prev)


def _use_interp(n_points: int) -> bool:
    if _INTERP_DISPATCH == "never" or n_points < _INTERP_MIN_POINTS:
        return False
    if _INTERP_DISPATCH == "always":
        return True
    return platform_choice(INTERP_BY_PLATFORM, "scattered voxel sampler")


def _size(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def scene_sample(field, position):
    """Uniform query interface: AnalyticScene, SdfVolume, ColumnField,
    or None."""
    if field is None:
        return jnp.full(position.shape[:-1], 128.0, dtype=jnp.float32)
    if isinstance(field, AnalyticScene):
        return field.distance(position)
    from .columns import ColumnField, sample_columns

    if isinstance(field, ColumnField):
        # Scattered queries through a ColumnField ALWAYS use the column
        # reconstruction (deterministic semantics — no size-dependent
        # path switch; the exact volume stays reachable as field.volume).
        return sample_columns(field, position)
    from .sampling import sample, sample_interp

    if _use_interp(_size(position.shape[:-1])):
        return sample_interp(field, position)
    return sample(field, position)


def scene_normal(field, position):
    if field is None:
        # Match scene_sample(None) = far distance: an empty field has no
        # surfaces — return the +z convention normal.
        shape = position.shape[:-1] + (3,)
        return jnp.broadcast_to(
            jnp.asarray([0.0, 0.0, 1.0], jnp.float32), shape)
    if isinstance(field, AnalyticScene):
        return field.estimate_normal(position)
    from .columns import ColumnField
    from .sampling import estimate_normal

    if isinstance(field, ColumnField):
        # The oracle tetrahedral normal of the EXACT field (the
        # visualize-parity path; the collision fast path goes through
        # scene_normal_p(fast=True) -> sample_columns_grad instead).
        return estimate_normal(field.volume, position)
    return estimate_normal(field, position)


def _separable_grid(x, y):
    """Detect (by STATIC shape) a planar separable grid query: x varies
    only along the last axis, y only along the second-to-last. The
    occlusion image and the pixel-grid AO prologue have this shape."""
    xs, ys = jnp.shape(x), jnp.shape(y)
    if len(ys) < 2:
        return False
    x_ok = len(xs) >= 1 and all(d == 1 for d in xs[:-1])
    y_ok = ys[-1] == 1 and all(d == 1 for d in ys[:-2])
    return x_ok and y_ok


def scene_sample_p(field, x, y, z):
    """Planar scene query: component arrays in, distance out. Dispatches
    to the unrolled analytic fast path; SdfVolumes route by query shape
    (separable grid -> exact matmul resample; large scattered -> the
    platform's choice of gather or interpolation matrix, `_use_interp`;
    small -> gather). See sampling.py docstring."""
    if isinstance(field, AnalyticScene):
        return field.distance_p(x, y, z)
    from . import sampling
    from .columns import ColumnField

    vol_field = field.volume if isinstance(field, ColumnField) else field
    if isinstance(vol_field, sampling.SdfVolume) and _separable_grid(x, y):
        # Separable grid queries stay EXACT through a ColumnField (the
        # occlusion image / nomination stack): matmul resample of the
        # underlying volume.
        xs = jnp.reshape(x, (-1,))
        ys = jnp.reshape(y, (-1,))
        return sampling.sample_grid(vol_field, xs, ys, z)
    shape = jnp.broadcast_shapes(jnp.shape(x), jnp.shape(y), jnp.shape(z))
    pos = jnp.stack([jnp.broadcast_to(x, shape), jnp.broadcast_to(y, shape),
                     jnp.broadcast_to(z, shape)], axis=-1)
    return scene_sample(field, pos)


def scene_sample_grad_p(field, x, y, z):
    """Fused distance + normalized fast-normal at the SAME positions, or
    None when the field has no fused path (analytic scenes keep their
    closed-form per-primitive normals; small volume batches keep the
    gather oracle).

    The collision integrate's substeps==1 case calls this instead of
    scene_sample_p + scene_normal_p(fast=True): at one substep the
    normal position IS the step-sample position, and on the map/interp
    matmul paths the gradient rows ride the same stage-1 intermediate,
    so fusing saves one full 1M-point sampling pass."""
    from .columns import ColumnField, sample_columns_grad
    from .sampling import SdfVolume, sample_interp_grad

    shape = jnp.broadcast_shapes(jnp.shape(x), jnp.shape(y), jnp.shape(z))
    if isinstance(field, ColumnField):
        sampler = sample_columns_grad
    elif isinstance(field, SdfVolume) and _use_interp(_size(shape)):
        sampler = sample_interp_grad
    else:
        return None
    pos = jnp.stack([jnp.broadcast_to(x, shape),
                     jnp.broadcast_to(y, shape),
                     jnp.broadcast_to(z, shape)], axis=-1)
    d, g = sampler(field, pos)
    norm = jnp.sqrt(jnp.sum(g * g, axis=-1, keepdims=True))
    g = jnp.where(norm > 1e-9, g / jnp.maximum(norm, 1e-9), 0.0)
    return d, g[..., 0], g[..., 1], g[..., 2]


def scene_column_images(field, nh: int, nw: int, nscale,
                        world_offset=None):
    """Closed-form column-interval images `(h_top, h_bot)` of an
    analytic scene on an (nh, nw) pixel-CENTER grid (centers at
    (i + 0.5) / nscale [+ world_offset] world units — the convention of
    `columns.resample_map_to_grid`), or None when the scene has content
    without a column form (rotated groups, polygon volumes, the
    vectorized many-prim path).

    The analytic analog of `ColumnField.h_top/h_bot`: it lets the scan
    shadows' carried-interval 3D refine (scan_shadows.py) run on
    analytic scenes with ZERO full-resolution scene evaluations — the
    refine reconstructs candidate distances elementwise from the
    carried flatland min + this blocker interval instead of
    re-evaluating every primitive per (light, pixel).

    Intervals are EXACT per column: boxes / vertical cylinders /
    octagon prisms are z-extruded ([cz-sz, cz+sz]); ellipsoids and
    spheroids get per-column caps from their cross-section radius (the
    zero crossing of the 3D SDF along z, solved in closed form).
    Overlapping columns merge into one interval (min bottom / max top)
    — the ColumnField contract (columns.py docstring); empty columns
    carry the FOOTPRINT-NEAREST primitive's interval so near-miss
    nominations reconstruct against the right blocker. The refine's
    footprint term stays the carried flatland min, so reconstruction
    error inherits the measured ColumnField bounds
    (tests/test_columns.py, tests/test_refine_quality.py)."""
    counts = field._counts()
    if sum(counts) == 0 or sum(counts) > field._UNROLL_LIMIT:
        return None
    if field.polygons is not None:
        return None
    if any(field.group_rotated):
        return None
    supported = {sp.TYPE_BOX, sp.TYPE_CYLINDER, sp.TYPE_OCTAGON,
                 sp.TYPE_ELLIPSOID, sp.TYPE_SPHEROID}
    if any(t not in supported for t in field.group_types):
        return None

    xs = (jnp.arange(nw, dtype=jnp.float32) + 0.5) / nscale
    ys = (jnp.arange(nh, dtype=jnp.float32) + 0.5) / nscale
    if world_offset is not None:
        xs = xs + world_offset[0]
        ys = ys + world_offset[1]
    xg = xs[None, :]
    yg = ys[:, None]

    _BIG_H = 4096.0  # matches _upsample_nominated's neutral fill
    t_occ = jnp.full((nh, nw), -_BIG_H, jnp.float32)
    b_occ = jnp.full((nh, nw), _BIG_H, jnp.float32)
    best_f = jnp.full((nh, nw), _FAR, jnp.float32)
    best_t = jnp.full((nh, nw), _BIG_H, jnp.float32)
    best_b = jnp.full((nh, nw), -_BIG_H, jnp.float32)
    zero = jnp.zeros((), jnp.float32)
    for gi, type_id in enumerate(field.group_types):
        centers = field.centers[gi]
        sizes = field.sizes[gi]
        fn = sp.PLANAR_EVALUATORS[type_id]
        for i in range(counts[gi]):
            px = xg - centers[i, 0]
            py = yg - centers[i, 1]
            sx, sy, sz = sizes[i, 0], sizes[i, 1], sizes[i, 2]
            # Footprint = the prim's own center plane (pz = 0): the 2D
            # cross-section SDF for prisms, the equator for quadrics.
            f2 = fn(px, py, zero, sx, sy, sz)
            cz = centers[i, 2]
            if type_id in (sp.TYPE_BOX, sp.TYPE_CYLINDER,
                           sp.TYPE_OCTAGON):
                half = jnp.broadcast_to(sz, f2.shape)
            elif type_id == sp.TYPE_ELLIPSOID:
                sxs = jnp.maximum(sx, 1e-6)
                sys_ = jnp.maximum(sy, 1e-6)
                rr = (px / sxs) ** 2 + (py / sys_) ** 2
                half = sz * jnp.sqrt(jnp.maximum(1.0 - rr, 0.0))
            else:  # TYPE_SPHEROID: rounded box cross-section along z
                ms = jnp.minimum(sx, jnp.minimum(sy, sz))
                ax = jnp.maximum(jnp.abs(px) - (sx - ms), 0.0)
                ay = jnp.maximum(jnp.abs(py) - (sy - ms), 0.0)
                half = (sz - ms) + jnp.sqrt(
                    jnp.maximum(ms * ms - (ax * ax + ay * ay), 0.0))
            occupied = f2 < 0.0
            ti = cz + half
            bi = cz - half
            t_occ = jnp.where(occupied, jnp.maximum(t_occ, ti), t_occ)
            b_occ = jnp.where(occupied, jnp.minimum(b_occ, bi), b_occ)
            nearer = f2 < best_f
            best_t = jnp.where(nearer, ti, best_t)
            best_b = jnp.where(nearer, bi, best_b)
            best_f = jnp.minimum(best_f, f2)
    any_occ = t_occ > -_BIG_H
    t_img = jnp.where(any_occ, t_occ, best_t)
    b_img = jnp.where(any_occ, b_occ, best_b)
    # Scene footprint map (min over prims): the refine's footprint term
    # — carrying it beats the flatland min when the trace plane sits
    # ABOVE a short blocker's top (the plane reads footprint + vertical
    # offset there; the true footprint still goes negative inside the
    # blocker, so the reconstruction recovers shadows the flatland
    # plane missed — the "short" scene class of test_refine_quality).
    return t_img, b_img, best_f


def scene_normal_p(field, x, y, z, fast: bool = False):
    """Planar normal query -> (nx, ny, nz). fast=True selects the
    closed-form per-primitive normals (collision path)."""
    if field is None:
        shape = jnp.broadcast_shapes(jnp.shape(x), jnp.shape(y),
                                     jnp.shape(z))
        zero = jnp.zeros(shape, jnp.float32)
        return zero, zero, jnp.ones(shape, jnp.float32)
    if isinstance(field, AnalyticScene):
        return field.normal_fast_p(x, y, z) if fast else \
            field.normal_p(x, y, z)
    shape = jnp.broadcast_shapes(jnp.shape(x), jnp.shape(y), jnp.shape(z))
    pos = jnp.stack([jnp.broadcast_to(x, shape), jnp.broadcast_to(y, shape),
                     jnp.broadcast_to(z, shape)], axis=-1)
    if fast:
        from .columns import ColumnField, sample_columns_grad

        if isinstance(field, ColumnField):
            # Collision fast normal from the column reconstruction's own
            # gradient (side contact -> footprint-map gradient, cap
            # contact -> +-z).
            _, g = sample_columns_grad(field, pos)
            norm = jnp.sqrt(jnp.sum(g * g, axis=-1, keepdims=True))
            g = jnp.where(norm > 1e-9, g / jnp.maximum(norm, 1e-9), 0.0)
            return g[..., 0], g[..., 1], g[..., 2]
    if fast and _use_interp(_size(shape)):
        # Collision fast normal: the trilinear interpolant's own world
        # gradient from the interpolation-matrix path (normalized),
        # gather-free.
        from .sampling import SdfVolume, sample_interp_grad

        if isinstance(field, SdfVolume):
            _, g = sample_interp_grad(field, pos)
            norm = jnp.sqrt(jnp.sum(g * g, axis=-1, keepdims=True))
            g = jnp.where(norm > 1e-9, g / jnp.maximum(norm, 1e-9), 0.0)
            return g[..., 0], g[..., 1], g[..., 2]
    n = scene_normal(field, pos)
    return n[..., 0], n[..., 1], n[..., 2]
