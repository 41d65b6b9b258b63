"""Signed-distance primitives (the obstruction shape library).

JAX re-expression of /root/reference/Illuminant/Shaders/DistanceFunctionCommon.fxh
(iq's public distance formulas: box, ellipsoid improved-V2, capped cylinder,
spheroid via elongation, octagon prism; quaternion local rotation).

The reference dispatches per obstruction *type* with one instanced draw per
type (LightingRenderer.DistanceField.cs:347-399). Here we evaluate all
shapes branchlessly and select by type id — obstruction counts are tiny
(tens), the field grid is the big axis, and computing five cheap vector
formulas then selecting avoids any divergence or regrouping.

Type ids match the shader's evaluateByTypeId switch
(DistanceFunctionCommon.fxh:167-186). Deviation: type NONE returns +INF
instead of 0 so that padded (inactive) obstruction slots are identity under
the min-reduce that composes a scene's field (the reference never draws
type-none instances at all; returning 0 would mark surface everywhere).
"""

from __future__ import annotations

import jax.numpy as jnp

TYPE_NONE = 0
TYPE_ELLIPSOID = 1
TYPE_BOX = 2
TYPE_CYLINDER = 3
TYPE_SPHEROID = 4
TYPE_OCTAGON = 5

_NONE_DISTANCE = 1e9


def rotate_by_quaternion(p, q):
    """Rotate vectors p (..., 3) by quaternions q (..., 4) (x, y, z, w).

    Matches DistanceFunctionCommon.fxh:23-26 rotateLocalPosition
    (q * (p, 0) * conj(q)), computed via the expanded cross-product form:
    p + 2 * cross(q.xyz, cross(q.xyz, p) + w * p).
    """
    qv = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * jnp.cross(qv, p)
    return p + w * t + jnp.cross(qv, t)


def _length(v, axis=-1):
    # The epsilon keeps sqrt differentiable at 0 — reverse-mode gradients
    # (sdf/analytic.py estimate_normal) otherwise NaN exactly on flat
    # faces and inside boxes, which silently zeroed collision normals.
    return jnp.sqrt(jnp.sum(v * v, axis=axis) + 1e-12)


def _op_elongate(p, h):
    """iq opElongate (DistanceFunctionCommon.fxh:43-46).

    Returns (q_xyz (...,3), w (...,)).
    """
    q = jnp.abs(p) - h
    w = jnp.minimum(jnp.max(q, axis=-1), 0.0)
    return jnp.sign(p) * jnp.maximum(q, 0.0), w


def sd_box(p, size):
    """Axis-aligned box half-extents `size` (fxh:48-63, local frame)."""
    d = jnp.abs(p) - size
    outside = _length(jnp.maximum(d, 0.0))
    inside = jnp.minimum(jnp.max(d, axis=-1), 0.0)
    return inside + outside


def sd_ellipsoid(p, r):
    """iq improved-V2 ellipsoid (fxh:92-99)."""
    k0 = _length(p / r)
    k1 = _length(p / (r * r))
    near = (k0 - 1.0) * jnp.min(r, axis=-1)
    far = k0 * (k0 - 1.0) / jnp.maximum(k1, 1e-12)
    return jnp.where(k0 < 1.0, near, far)


def sd_spheroid(p, size):
    """Sphere of radius min(size) elongated to size (fxh:65-75)."""
    min_size = jnp.min(size, axis=-1, keepdims=True)
    elongation = size - min_size
    q, w = _op_elongate(p, elongation)
    return w + (_length(q) - min_size[..., 0])


def sd_cylinder(p, size):
    """Capped cylinder: radius length(size.xy), half-height size.z (fxh:110-121)."""
    r = _length(size[..., :2])
    h = size[..., 2]
    d_xy = _length(p[..., :2]) - r
    d_z = jnp.abs(p[..., 2]) - h
    d = jnp.stack([d_xy, d_z], axis=-1)
    return jnp.minimum(jnp.max(d, axis=-1), 0.0) + _length(jnp.maximum(d, 0.0))


def _sd_octagon_prism(p, r, h):
    """iq octagon prism (fxh:139-152)."""
    kx = -0.9238795325
    ky = 0.3826834323
    kz = 0.4142135623
    p = jnp.abs(p)
    px, py, pz = p[..., 0], p[..., 1], p[..., 2]

    dot1 = kx * px + ky * py
    m1 = 2.0 * jnp.minimum(dot1, 0.0)
    px = px - m1 * kx
    py = py - m1 * ky

    dot2 = -kx * px + ky * py
    m2 = 2.0 * jnp.minimum(dot2, 0.0)
    px = px - m2 * -kx
    py = py - m2 * ky

    px = px - jnp.clip(px, -kz * r, kz * r)
    py = py - r
    dx = jnp.sqrt(px * px + py * py) * jnp.sign(py)
    dz = pz - h
    d = jnp.stack([dx, dz], axis=-1)
    return jnp.minimum(jnp.max(d, axis=-1), 0.0) + _length(jnp.maximum(d, 0.0))


def sd_octagon(p, size):
    """Octagon prism elongated over xy (fxh:154-164)."""
    min_size = jnp.minimum(size[..., 0], size[..., 1])
    elongation = jnp.stack(
        [
            size[..., 0] - min_size,
            size[..., 1] - min_size,
            jnp.zeros_like(min_size),
        ],
        axis=-1,
    )
    q, w = _op_elongate(p, elongation)
    return w + _sd_octagon_prism(q, min_size, size[..., 2])


def evaluate_by_type(type_id, world_position, center, size, rotation):
    """Branchless evaluateByTypeId (fxh:167-186).

    type_id: (...,) int32; world_position/center/size: (..., 3);
    rotation: (..., 4) quaternion (x, y, z, w). Broadcasts freely.
    Inactive slots (TYPE_NONE) return +1e9 (see module docstring).
    """
    p = rotate_by_quaternion(world_position - center, rotation)

    d_ellipsoid = sd_ellipsoid(p, jnp.maximum(size, 1e-6))
    d_box = sd_box(p, size)
    d_cylinder = sd_cylinder(p, size)
    d_spheroid = sd_spheroid(p, size)
    d_octagon = sd_octagon(p, size)

    t = jnp.abs(type_id)
    result = jnp.full(jnp.broadcast_shapes(t.shape, d_box.shape), _NONE_DISTANCE,
                      dtype=jnp.float32)
    result = jnp.where(t == TYPE_ELLIPSOID, d_ellipsoid, result)
    result = jnp.where(t == TYPE_BOX, d_box, result)
    result = jnp.where(t == TYPE_CYLINDER, d_cylinder, result)
    result = jnp.where(t == TYPE_SPHEROID, d_spheroid, result)
    result = jnp.where(t == TYPE_OCTAGON, d_octagon, result)
    return result


def scene_distance(world_position, types, centers, sizes, rotations):
    """Distance from points (..., 3) to the nearest of N obstructions.

    types (N,), centers/sizes (N, 3), rotations (N, 4). Composes by min —
    the array equivalent of the reference's MAX-blend over *encoded* distances
    (encoded = bias - d, so max(encoded) == min(d);
    LightingRenderer.DistanceField.cs:361-372, DistanceFieldCommon.fxh:264-270).
    """
    d = evaluate_by_type(
        types,
        world_position[..., None, :],
        centers,
        sizes,
        rotations,
    )
    return jnp.min(d, axis=-1)


# ---------------------------------------------------------------------------
# Planar (component-wise) variants — the fast path.
#
# The vector forms above take (..., 3) points; a minor dim of 3 makes every
# stack/reduce over it a strided, padded intermediate. The planar forms take x/y/z as separate broadcastable
# arrays (scene evaluation unrolls over the handful of obstructions), so the
# whole scene distance fuses into one elementwise pass over the query grid.
# Same math, same reference citations as the vector forms.
# ---------------------------------------------------------------------------


def rotate_by_quaternion_p(px, py, pz, qx, qy, qz, qw):
    """Planar rotateLocalPosition (DistanceFunctionCommon.fxh:23-26)."""
    tx = 2.0 * (qy * pz - qz * py)
    ty = 2.0 * (qz * px - qx * pz)
    tz = 2.0 * (qx * py - qy * px)
    ox = px + qw * tx + (qy * tz - qz * ty)
    oy = py + qw * ty + (qz * tx - qx * tz)
    oz = pz + qw * tz + (qx * ty - qy * tx)
    return ox, oy, oz


def _len3_p(x, y, z):
    return jnp.sqrt(x * x + y * y + z * z + 1e-12)


def _len2_p(x, y):
    return jnp.sqrt(x * x + y * y + 1e-12)


def sd_box_p(px, py, pz, sx, sy, sz):
    """Planar sd_box (fxh:48-63)."""
    dx = jnp.abs(px) - sx
    dy = jnp.abs(py) - sy
    dz = jnp.abs(pz) - sz
    inside = jnp.minimum(jnp.maximum(dx, jnp.maximum(dy, dz)), 0.0)
    outside = _len3_p(jnp.maximum(dx, 0.0), jnp.maximum(dy, 0.0),
                      jnp.maximum(dz, 0.0))
    return inside + outside


def sd_ellipsoid_p(px, py, pz, sx, sy, sz):
    """Planar iq improved-V2 ellipsoid (fxh:92-99)."""
    sx = jnp.maximum(sx, 1e-6)
    sy = jnp.maximum(sy, 1e-6)
    sz = jnp.maximum(sz, 1e-6)
    k0 = _len3_p(px / sx, py / sy, pz / sz)
    k1 = _len3_p(px / (sx * sx), py / (sy * sy), pz / (sz * sz))
    rmin = jnp.minimum(sx, jnp.minimum(sy, sz))
    near = (k0 - 1.0) * rmin
    far = k0 * (k0 - 1.0) / jnp.maximum(k1, 1e-12)
    return jnp.where(k0 < 1.0, near, far)


def _elongate_p(px, py, pz, hx, hy, hz):
    """Planar opElongate (fxh:43-46) -> (qx, qy, qz, w)."""
    ax = jnp.abs(px) - hx
    ay = jnp.abs(py) - hy
    az = jnp.abs(pz) - hz
    w = jnp.minimum(jnp.maximum(ax, jnp.maximum(ay, az)), 0.0)
    qx = jnp.sign(px) * jnp.maximum(ax, 0.0)
    qy = jnp.sign(py) * jnp.maximum(ay, 0.0)
    qz = jnp.sign(pz) * jnp.maximum(az, 0.0)
    return qx, qy, qz, w


def sd_spheroid_p(px, py, pz, sx, sy, sz):
    """Planar spheroid (fxh:65-75)."""
    ms = jnp.minimum(sx, jnp.minimum(sy, sz))
    qx, qy, qz, w = _elongate_p(px, py, pz, sx - ms, sy - ms, sz - ms)
    return w + (_len3_p(qx, qy, qz) - ms)


def sd_cylinder_p(px, py, pz, sx, sy, sz):
    """Planar capped cylinder (fxh:110-121)."""
    r = _len2_p(sx, sy)
    d_xy = _len2_p(px, py) - r
    d_z = jnp.abs(pz) - sz
    inside = jnp.minimum(jnp.maximum(d_xy, d_z), 0.0)
    outside = _len2_p(jnp.maximum(d_xy, 0.0), jnp.maximum(d_z, 0.0))
    return inside + outside


def sd_octagon_p(px, py, pz, sx, sy, sz):
    """Planar octagon prism elongated over xy (fxh:139-164)."""
    ms = jnp.minimum(sx, sy)
    qx, qy, qz, w = _elongate_p(px, py, pz, sx - ms, sy - ms,
                                jnp.zeros_like(ms) if hasattr(ms, "shape")
                                else 0.0)
    kx = -0.9238795325
    ky = 0.3826834323
    kz = 0.4142135623
    ax = jnp.abs(qx)
    ay = jnp.abs(qy)
    az = jnp.abs(qz)
    dot1 = kx * ax + ky * ay
    m1 = 2.0 * jnp.minimum(dot1, 0.0)
    ax = ax - m1 * kx
    ay = ay - m1 * ky
    dot2 = -kx * ax + ky * ay
    m2 = 2.0 * jnp.minimum(dot2, 0.0)
    ax = ax - m2 * -kx
    ay = ay - m2 * ky
    ax = ax - jnp.clip(ax, -kz * ms, kz * ms)
    ay = ay - ms
    dxo = jnp.sqrt(ax * ax + ay * ay + 1e-12) * jnp.sign(ay)
    dzo = az - sz
    inside = jnp.minimum(jnp.maximum(dxo, dzo), 0.0)
    outside = _len2_p(jnp.maximum(dxo, 0.0), jnp.maximum(dzo, 0.0))
    return w + inside + outside


PLANAR_EVALUATORS = {
    TYPE_ELLIPSOID: sd_ellipsoid_p,
    TYPE_BOX: sd_box_p,
    TYPE_CYLINDER: sd_cylinder_p,
    TYPE_SPHEROID: sd_spheroid_p,
    TYPE_OCTAGON: sd_octagon_p,
}


# --- Planar analytic normals (collision path) ------------------------------
# The field gradient of each primitive in closed form — ~1 distance-eval
# cost instead of reverse-mode AD's ~2x (plus its select-chain overhead).
# Normals feed particle bounce/redirect (UpdateParticleSystemWithDistance-
# Field.fx estimateNormal4) — orientation accuracy matters, magnitudes
# are renormalized by the caller.


def _nrm_safe(px, py, pz, fallback_z=1.0):
    l = jnp.sqrt(px * px + py * py + pz * pz)
    ok = l > 1e-9
    inv = 1.0 / jnp.where(ok, l, 1.0)
    return (jnp.where(ok, px * inv, 0.0),
            jnp.where(ok, py * inv, 0.0),
            jnp.where(ok, pz * inv, fallback_z))


def nrm_box_p(px, py, pz, bx, by, bz):
    qx = jnp.abs(px) - bx
    qy = jnp.abs(py) - by
    qz = jnp.abs(pz) - bz
    outside = (qx > 0.0) | (qy > 0.0) | (qz > 0.0)
    ox = jnp.sign(px) * jnp.maximum(qx, 0.0)
    oy = jnp.sign(py) * jnp.maximum(qy, 0.0)
    oz = jnp.sign(pz) * jnp.maximum(qz, 0.0)
    # Inside: face of the LEAST interior penetration (max q).
    mx = (qx >= qy) & (qx >= qz)
    my = (~mx) & (qy >= qz)
    ix = jnp.where(mx, jnp.sign(px), 0.0)
    iy = jnp.where(my, jnp.sign(py), 0.0)
    iz = jnp.where(~(mx | my), jnp.sign(pz), 0.0)
    return _nrm_safe(jnp.where(outside, ox, ix),
                     jnp.where(outside, oy, iy),
                     jnp.where(outside, oz, iz))


def nrm_ellipsoid_p(px, py, pz, rx, ry, rz):
    # Clamp like sd_ellipsoid_p: a zero extent would divide by 0 and
    # _nrm_safe would emit NaN normals for a shape whose distance path
    # renders fine.
    rx = jnp.maximum(rx, 1e-6)
    ry = jnp.maximum(ry, 1e-6)
    rz = jnp.maximum(rz, 1e-6)
    return _nrm_safe(px / (rx * rx), py / (ry * ry), pz / (rz * rz))


def nrm_cylinder_p(px, py, pz, sx, sy, sz):
    r = jnp.sqrt(sx * sx + sy * sy)
    h = sz
    lxy = jnp.sqrt(px * px + py * py + 1e-12)
    d_xy = lxy - r
    d_z = jnp.abs(pz) - h
    both_out = (d_xy > 0.0) & (d_z > 0.0)
    radial = d_xy >= d_z
    ox = px / lxy * jnp.maximum(d_xy, 0.0)
    oy = py / lxy * jnp.maximum(d_xy, 0.0)
    oz = jnp.sign(pz) * jnp.maximum(d_z, 0.0)
    nx = jnp.where(both_out, ox, jnp.where(radial, px / lxy, 0.0))
    ny = jnp.where(both_out, oy, jnp.where(radial, py / lxy, 0.0))
    nz = jnp.where(both_out, oz, jnp.where(radial, 0.0, jnp.sign(pz)))
    return _nrm_safe(nx, ny, nz)


def nrm_spheroid_p(px, py, pz, sx, sy, sz):
    # Elongated sphere: gradient points away from the inner core box
    # (the elongation region); deep inside the core, +z.
    m = jnp.minimum(sx, jnp.minimum(sy, sz))
    ex, ey, ez = sx - m, sy - m, sz - m
    dx = px - jnp.clip(px, -ex, ex)
    dy = py - jnp.clip(py, -ey, ey)
    dz = pz - jnp.clip(pz, -ez, ez)
    return _nrm_safe(dx, dy, dz)


def nrm_octagon_p(px, py, pz, sx, sy, sz):
    """Tetrahedral finite difference (the rare shape keeps the reference's
    estimateNormal4 form, VisualizeCommon.fxh)."""
    h = 0.5
    d1 = sd_octagon_p(px + h, py - h, pz - h, sx, sy, sz)
    d2 = sd_octagon_p(px - h, py - h, pz + h, sx, sy, sz)
    d3 = sd_octagon_p(px - h, py + h, pz - h, sx, sy, sz)
    d4 = sd_octagon_p(px + h, py + h, pz + h, sx, sy, sz)
    return _nrm_safe(d1 - d2 - d3 + d4, -d1 - d2 + d3 + d4,
                     -d1 + d2 - d3 + d4)


PLANAR_NORMALS = {
    TYPE_ELLIPSOID: nrm_ellipsoid_p,
    TYPE_BOX: nrm_box_p,
    TYPE_CYLINDER: nrm_cylinder_p,
    TYPE_SPHEROID: nrm_spheroid_p,
    TYPE_OCTAGON: nrm_octagon_p,
}


def rotate_by_quaternion_inverse_p(px, py, pz, qx, qy, qz, qw):
    """Rotate planar vectors by the conjugate quaternion (local -> world)."""
    return rotate_by_quaternion_p(px, py, pz, -qx, -qy, -qz, qw)
