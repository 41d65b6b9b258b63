"""Clamped bezier evaluation (device side).

Re-expresses the reference's GPU bezier evaluator
(/root/reference/Illuminant/Shaders/Bezier.fxh:21-177 and the mirrored CPU
implementation in Illuminant/Bezier.cs:432-833) as a branchless jnp function.
A `ClampedBezier` packs up to four control points of C channels plus a
`(min, inv_divisor, count, mode)` header; evaluation over a batch of input
values is fully vectorized (no lane divergence — every mode/count case is
computed and selected, which is cheaper than branching per element).

Semantics preserved from the reference:
  * count <= 1: constant `a`
  * count == 2: lerp(a, b, t)
  * count == 3: "shelf" step mode (t<=0 -> a, t>=1 -> c, else b)
    (Bezier.fxh:78-86)
  * count == 4: cubic de Casteljau
  * mode % 256: 0 = linear time, 1 = sine (t -> sin(t*pi/2)), 2 = exp (t^2)
  * mode > 255: repeating (loop), mode > 511: bouncing (ping-pong)
  * inv_divisor < 0 reverses time (Bezier.fxh:29-49)
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core.pytree import pytree_dataclass, static_field

# Time-mode flag bits (Bezier.cs BezierTimeMode / Bezier.fxh:24-60).
MODE_LINEAR = 0
MODE_SINE = 1
MODE_EXP = 2
MODE_LOOP_BIT = 256
MODE_BOUNCE_BIT = 512  # bouncing implies > 511 in the shader test


@pytree_dataclass
class ClampedBezier:
    """Uniform-style packed bezier.

    range_and_count: (4,) f32 = (min_value, inv_divisor, count, mode)
    points:          (4, C) f32 control points a, b, c, d (unused rows = 0)
    """

    range_and_count: jnp.ndarray
    points: jnp.ndarray
    # Static shortcut: single-control-point beziers evaluate to points[0]
    # regardless of t — skipping the de Casteljau chain matters when a
    # constant ramp is evaluated per particle per tick.
    is_constant: bool = static_field(default=False)

    @property
    def channels(self) -> int:
        return self.points.shape[-1]


def pack_bezier(
    points,
    min_value: float = 0.0,
    max_value: float = 1.0,
    mode: int = MODE_LINEAR,
) -> ClampedBezier:
    """Build a ClampedBezier from a list of control points.

    Mirrors Bezier.cs `ClampedBezier1/2/4` constructors: inv_divisor is
    1 / (max - min) with sign encoding reversed time when max < min.
    """
    pts = jnp.atleast_2d(jnp.asarray(points, dtype=jnp.float32))
    count = pts.shape[0]
    if count > 4:
        raise ValueError("bezier supports at most 4 control points")
    pad = jnp.zeros((4 - count, pts.shape[1]), dtype=jnp.float32)
    pts4 = jnp.concatenate([pts, pad], axis=0)
    divisor = max_value - min_value
    if divisor == 0.0:
        inv = 1.0
    else:
        inv = 1.0 / divisor
    rc = jnp.asarray(
        [min_value, inv, float(count), float(mode)], dtype=jnp.float32
    )
    return ClampedBezier(range_and_count=rc, points=pts4)


def constant_bezier(value) -> ClampedBezier:
    """A single-point (constant) bezier."""
    v = jnp.atleast_1d(jnp.asarray(value, dtype=jnp.float32))
    return pack_bezier(v[None, :]).replace(is_constant=True)


def t_for_scaled_bezier(range_and_count, value):
    """Time-warp an input value into bezier parameter t in [0, 1].

    Port of Bezier.fxh:21-63 `tForScaledBezier`. Returns (count, t).
    Uses fmod (sign of dividend) to match HLSL `%` semantics.
    """
    rc = range_and_count
    min_value, inv_divisor, count, mode_f = rc[0], rc[1], rc[2], rc[3]
    mode = jnp.abs(mode_f).astype(jnp.int32)
    repeating = mode > 255
    bouncing = mode > 511
    reverse = inv_divisor < 0

    t = (value - min_value) * jnp.abs(inv_divisor)

    # Bouncing (ping-pong): t*2 wrapped into [0,2], folded at 1.
    tb = t * 2.0
    tb = jnp.where(reverse, 2.0 - jnp.fmod(tb, 2.0), jnp.fmod(tb, 2.0))
    tb = jnp.where(tb > 1.0, 2.0 - tb, tb)

    # Repeating (loop).
    tr = jnp.where(reverse, 1.0 - jnp.fmod(t, 1.0), jnp.fmod(t, 1.0))

    # Clamped (once).
    tc = jnp.clip(t, 0.0, 1.0)
    tc = jnp.where(reverse, 1.0 - tc, tc)

    t = jnp.where(bouncing, tb, jnp.where(repeating, tr, tc))

    base_mode = jnp.mod(mode, 256)
    t = jnp.where(base_mode == MODE_SINE, jnp.sin(t * (jnp.pi * 0.5)), t)
    t = jnp.where(base_mode == MODE_EXP, t * t, t)
    return count, t


def evaluate_at_t(points, count, t):
    """De Casteljau with constant/linear/shelf shortcuts (Bezier.fxh:65-95).

    points: (4, C); t: (...,) -> result (..., C). Branchless select.
    """
    a, b, c, d = points[0], points[1], points[2], points[3]
    tt = t[..., None]

    ab = a + (b - a) * tt
    bc = b + (c - b) * tt
    cd = c + (d - c) * tt
    abbc = ab + (bc - ab) * tt
    bccd = bc + (cd - bc) * tt
    cubic = abbc + (bccd - abbc) * tt

    shelf = jnp.where(tt <= 0.0, a, jnp.where(tt >= 1.0, c, b))

    result = jnp.where(
        count <= 1.5,
        a,
        jnp.where(count <= 2.5, ab, jnp.where(count <= 3.5, shelf, cubic)),
    )
    return jnp.broadcast_to(result, t.shape + (points.shape[-1],))


def evaluate_bezier(bezier: ClampedBezier, value):
    """Evaluate a packed bezier at `value` (any batch shape).

    Returns shape value.shape + (C,). Port of Bezier.fxh evaluateBezier*.
    """
    value = jnp.asarray(value, dtype=jnp.float32)
    if bezier.is_constant:
        return jnp.broadcast_to(
            bezier.points[0], value.shape + (bezier.points.shape[-1],)
        )
    count, t = t_for_scaled_bezier(bezier.range_and_count, value)
    return evaluate_at_t(bezier.points, count, t)


# --- BezierM over DynamicMatrix (Bezier.cs:379-424) ------------------------


@pytree_dataclass
class DynamicMatrix:
    """Squared.Render DynamicMatrix: either an explicit 4x4 matrix or a
    generated one from (angle degrees, scale, translation) — a 2D rotation
    about +z. `is_dynamic` selects the generated form."""

    matrix: jnp.ndarray  # (4, 4) row-vector convention
    angle: jnp.ndarray  # () degrees
    scale: jnp.ndarray  # ()
    translation: jnp.ndarray  # (3,)
    is_dynamic: jnp.ndarray  # () f32 flag

    @staticmethod
    def from_components(angle=0.0, scale=1.0, translation=(0.0, 0.0, 0.0)):
        return DynamicMatrix(
            matrix=jnp.eye(4, dtype=jnp.float32),
            angle=jnp.asarray(angle, jnp.float32),
            scale=jnp.asarray(scale, jnp.float32),
            translation=jnp.asarray(translation, jnp.float32),
            is_dynamic=jnp.asarray(1.0, jnp.float32),
        )

    @staticmethod
    def from_matrix(matrix):
        return DynamicMatrix(
            matrix=jnp.asarray(matrix, jnp.float32),
            angle=jnp.asarray(0.0, jnp.float32),
            scale=jnp.asarray(1.0, jnp.float32),
            translation=jnp.zeros((3,), jnp.float32),
            is_dynamic=jnp.asarray(0.0, jnp.float32),
        )

    def regenerate(self):
        """DynamicMatrix.Regenerate: rotation(angle) * scale + translation
        (row-vector convention; identity when not dynamic)."""
        rad = self.angle * (jnp.pi / 180.0)
        c = jnp.cos(rad) * self.scale
        s = jnp.sin(rad) * self.scale
        tx, ty, tz = (self.translation[0], self.translation[1],
                      self.translation[2])
        z = jnp.zeros(())
        one = jnp.ones(())
        gen = jnp.stack([
            jnp.stack([c, s, z, z]),
            jnp.stack([-s, c, z, z]),
            jnp.stack([z, z, self.scale, z]),
            jnp.stack([tx, ty, tz, one]),
        ])
        return jnp.where(self.is_dynamic > 0.5, gen, self.matrix)


@pytree_dataclass
class BezierM:
    """Bezier over DynamicMatrix (Bezier.cs:379-424). Holds the packed
    time header plus the four control DynamicMatrix values."""

    range_and_count: jnp.ndarray  # (4,) like ClampedBezier
    a: DynamicMatrix
    b: DynamicMatrix
    c: DynamicMatrix
    d: DynamicMatrix


def pack_bezier_matrix(points, min_value=0.0, max_value=1.0,
                       mode=MODE_LINEAR) -> BezierM:
    pts = list(points)
    if not 1 <= len(pts) <= 4:
        raise ValueError("BezierM supports 1-4 control matrices")
    while len(pts) < 4:
        pts.append(pts[-1])
    header = pack_bezier(
        [[0.0]] * min(len(points), 4), min_value, max_value, mode
    ).range_and_count
    header = header.at[2].set(float(len(points)))
    return BezierM(range_and_count=header, a=pts[0], b=pts[1], c=pts[2],
                   d=pts[3])


def evaluate_bezier_matrix(bm: BezierM, value) -> jnp.ndarray:
    """Bezier.cs:379-424: fully-dynamic control points interpolate
    (angle, scale) and translation through the bezier then regenerate;
    otherwise the four matrix rows interpolate component-wise. -> (4, 4)."""
    count, t = t_for_scaled_bezier(bm.range_and_count, jnp.asarray(value))

    fully_dynamic = (
        (bm.a.is_dynamic > 0.5) & (bm.b.is_dynamic > 0.5)
        & (bm.c.is_dynamic > 0.5) & (bm.d.is_dynamic > 0.5)
    )

    # Dynamic path: bezier over (angle, scale) + translation.
    ang_scale = jnp.stack([
        jnp.stack([m.angle, m.scale]) for m in (bm.a, bm.b, bm.c, bm.d)
    ])  # (4, 2)
    p = evaluate_at_t(ang_scale, count, t)
    trans = jnp.stack([
        jnp.concatenate([m.translation, jnp.ones((1,), jnp.float32)])
        for m in (bm.a, bm.b, bm.c, bm.d)
    ])  # (4, 4)
    tr = evaluate_at_t(trans, count, t)
    dyn = DynamicMatrix.from_components(
        angle=p[..., 0], scale=p[..., 1], translation=tr[..., :3]
    ).regenerate()

    # Matrix path: per-row component-wise bezier.
    rows = []
    for r in range(4):
        ctrl = jnp.stack([m.regenerate()[r] for m in
                          (bm.a, bm.b, bm.c, bm.d)])  # (4, 4)
        rows.append(evaluate_at_t(ctrl, count, t))
    mat = jnp.stack(rows, axis=-2)

    return jnp.where(fully_dynamic, dyn, mat)
