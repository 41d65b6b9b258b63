"""Distance-field sampling: the innermost primitive of every hot loop.

Port of sampleDistanceFieldEx (/root/reference/Illuminant/Shaders/
DistanceFieldCommon.fxh:313-353): clamp the query to the volume, take a
bilinear-XY + linear-Z (trilinear) sample, and add the euclidean distance
from the query to the volume so out-of-volume queries stay conservative.
The reference's 3-slices-per-RGBA-texel packing and atlas UV math
(fxh:303-311, 337-346) disappear — the field here is a plain (S, H, W)
array and Z interpolation indexes adjacent slices directly.

Also `estimate_normal`: 4-tap tetrahedral normal
(VisualizeCommon.fxh:44-63), used by particle SDF collision and field
visualization.

Besides the 8-tap gather `sample` (the semantics oracle), two
gather-free forms:

  * `sample_interp` / `sample_interp_grad` — scattered points. Folds
    the trilinear lerp weights into two-nonzero interpolation-row
    matrices and contracts them with the volume as a matmul
    (Bx @ D^T -> (N, S*H), then cheap masked reductions over y and
    slices). Which of it and the gather large scattered batches take is
    a per-platform choice (`analytic.INTERP_BY_PLATFORM`, measured in
    PERF.md). bf16 operands: the
    error is RELATIVE (~2^-8), and an SDF is 1-Lipschitz, so the
    absolute error NEAR SURFACES — the only place distance values
    matter — is bounded by ~2^-8 * voxel_size (measured in
    tests/test_sampling_fast.py).
  * `grid_stack` / `sample_stack_z` — pixel-anchored queries (the
    occlusion image, AO probes: xy on the frame's pixel grid, z
    varying per query). Separable interpolation matrices resample the
    volume onto the pixel grid with two SMALL exact matmuls per slice,
    then the per-query z-lerp is an unrolled masked sum over the S
    slices — zero gathers, exact trilinear semantics.

`scene_sample_p` (sdf/analytic.py) dispatches between these by the
STATIC shape of the query: separable (1,..,W)x(H,..,1) planar queries
take the grid path, large scattered batches the platform's choice,
small ones the reference gather path (kept as the semantics oracle).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .volume import SdfVolume


def _gather2d(data, si, yi, xi):
    """data (S, H, W); integer index arrays broadcastable to a common shape."""
    return data[si, yi, xi]


def sample(volume: SdfVolume, position):
    """Trilinear distance sample at world positions (..., 3) -> (...,)."""
    c = volume.config
    data = volume.data

    px = position[..., 0]
    py = position[..., 1]
    pz = position[..., 2] - c.z_offset

    ex = float(c.virtual_width)
    ey = float(c.virtual_height)
    ez = float(c.virtual_depth)

    cx = jnp.clip(px, 0.0, ex)
    cy = jnp.clip(py, 0.0, ey)
    cz = jnp.clip(pz, 0.0, ez)

    # Distance from the query to the volume AABB (fxh:320-321).
    dx = -jnp.minimum(px, 0.0) + jnp.maximum(px - ex, 0.0)
    dy = -jnp.minimum(py, 0.0) + jnp.maximum(py - ey, 0.0)
    dz = -jnp.minimum(pz, 0.0) + jnp.maximum(pz - ez, 0.0)
    distance_to_volume = jnp.sqrt(dx * dx + dy * dy + dz * dz)

    # Z -> slice space (fxh:325-327): slice s sits at z = s * sliceZSize.
    z_to_slice = c.slice_count / ez
    slice_pos = jnp.minimum(cz, volume.max_valid_z) * z_to_slice
    s0 = jnp.floor(slice_pos)
    sw = slice_pos - s0
    s0i = jnp.clip(s0.astype(jnp.int32), 0, c.slice_count - 1)
    s1i = jnp.clip(s0i + 1, 0, c.slice_count - 1)

    # XY -> texel space; texel centers at (i + 0.5) (GPU bilinear).
    tx = cx * c.scale_x - 0.5
    ty = cy * c.scale_y - 0.5
    x0 = jnp.floor(tx)
    y0 = jnp.floor(ty)
    wx = tx - x0
    wy = ty - y0
    x0i = jnp.clip(x0.astype(jnp.int32), 0, c.slice_width - 1)
    x1i = jnp.clip(x0i + 1, 0, c.slice_width - 1)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, c.slice_height - 1)
    y1i = jnp.clip(y0i + 1, 0, c.slice_height - 1)

    def bilinear(si):
        v00 = _gather2d(data, si, y0i, x0i)
        v01 = _gather2d(data, si, y0i, x1i)
        v10 = _gather2d(data, si, y1i, x0i)
        v11 = _gather2d(data, si, y1i, x1i)
        top = v00 + (v01 - v00) * wx
        bot = v10 + (v11 - v10) * wx
        return top + (bot - top) * wy

    a = bilinear(s0i)
    b = bilinear(s1i)
    d = a + (b - a) * sw

    return d + distance_to_volume


def sample_or_max(volume: SdfVolume | None, position, maximum_z: float = 128.0):
    """sampleDistanceField (fxh:355-364): no field -> max encoded distance."""
    if volume is None:
        return jnp.full(position.shape[:-1], maximum_z, dtype=jnp.float32)
    return sample(volume, position)


# Tetrahedral offsets k.xyy, k.yyx, k.yxy, k.xxx with k = (1, -1)
# (VisualizeCommon.fxh:44-45).
# numpy, not jnp: a module-level jnp constant created during a lazy
# import INSIDE a jit trace becomes a tracer of that trace and leaks
# into every later trace (UnexpectedTracerError).
_NORMAL_WEIGHTS = np.asarray(
    [
        [1.0, -1.0, -1.0],
        [-1.0, -1.0, 1.0],
        [-1.0, 1.0, -1.0],
        [1.0, 1.0, 1.0],
    ],
    dtype=np.float32,
)


def estimate_normal(volume: SdfVolume, position):
    """4-tap tetrahedral gradient estimate (VisualizeCommon.fxh:47-63).

    Tap offsets are one voxel in world units: (1/scale_x, 1/scale_y,
    slice_z_size) — the VISUALIZE_TEXEL default (VisualizeCommon.fxh:9-16).
    Returns unit normals (..., 3); zero-length gradients normalize to 0.
    """
    c = volume.config
    texel = jnp.asarray(
        [1.0 / c.scale_x, 1.0 / c.scale_y, c.slice_z_size],
        dtype=jnp.float32,
    )
    result = jnp.zeros(position.shape, dtype=jnp.float32)
    for i in range(4):
        w = _NORMAL_WEIGHTS[i]
        d = sample(volume, position + w * texel)
        result = result + w * d[..., None]
    norm = jnp.sqrt(jnp.sum(result * result, axis=-1, keepdims=True))
    return jnp.where(norm > 1e-9, result / jnp.maximum(norm, 1e-9), 0.0)


# ---------------------------------------------------------------------------
# Gather-free paths (see module docstring). The gather `sample` above stays the
# semantics oracle; everything here is pinned against it by
# tests/test_sampling_fast.py.

def _clamped_axes(volume: SdfVolume, px, py, pz):
    """Shared clamp/convert logic, exactly mirroring `sample`.

    Returns texel-space coords (tx, ty), slice-space coord (sp, clamped
    to [0, S-1]), the signed out-of-AABB offsets (ux, uy, uz) whose norm
    is the conservative add-on, and the per-axis inside masks (gradient
    of a clamped coordinate is zero outside).
    """
    c = volume.config
    ex = float(c.virtual_width)
    ey = float(c.virtual_height)
    ez = float(c.virtual_depth)
    pz = pz - c.z_offset

    cx = jnp.clip(px, 0.0, ex)
    cy = jnp.clip(py, 0.0, ey)
    cz = jnp.clip(pz, 0.0, ez)

    ux = jnp.minimum(px, 0.0) + jnp.maximum(px - ex, 0.0)
    uy = jnp.minimum(py, 0.0) + jnp.maximum(py - ey, 0.0)
    uz = jnp.minimum(pz, 0.0) + jnp.maximum(pz - ez, 0.0)

    z_to_slice = c.slice_count / ez
    zc = jnp.minimum(cz, volume.max_valid_z)
    sp = jnp.minimum(zc * z_to_slice, float(c.slice_count - 1))

    tx = cx * c.scale_x - 0.5
    ty = cy * c.scale_y - 0.5

    in_x = (px > 0.0) & (px < ex)
    in_y = (py > 0.0) & (py < ey)
    in_z = (pz > 0.0) & (pz < ez) & (cz < volume.max_valid_z)
    return tx, ty, sp, (ux, uy, uz), (in_x, in_y, in_z)


def _interp_rows(t, n: int, dtype):
    """Interpolation-row matrix (..., n): (1-w) at i0, w at i1 = min(i0+1,
    n-1), indices clipped exactly like `sample` (i0 clipped FIRST, then
    i1 from the clipped i0 — matching the oracle's edge semantics)."""
    i0 = jnp.floor(t)
    w = (t - i0)[..., None]
    i0 = jnp.clip(i0.astype(jnp.int32), 0, n - 1)[..., None]
    i1 = jnp.minimum(i0 + 1, n - 1)
    iota = jnp.arange(n, dtype=jnp.int32)
    rows = (iota == i0) * (1.0 - w) + (iota == i1) * w
    return rows.astype(dtype)


def _deriv_rows(t, n: int, dtype):
    """d(interp)/dt rows: -1 at i0, +1 at i1 (zero when both clip to the
    same texel — the clamped-edge gradient)."""
    i0 = jnp.floor(t)
    i0 = jnp.clip(i0.astype(jnp.int32), 0, n - 1)[..., None]
    i1 = jnp.minimum(i0 + 1, n - 1)
    iota = jnp.arange(n, dtype=jnp.int32)
    rows = (iota == i1).astype(jnp.float32) - (iota == i0).astype(
        jnp.float32)
    return rows.astype(dtype)


def _interp_core(volume: SdfVolume, d2, pos_flat, want_grad: bool):
    """Matmul trilinear on a flat (N, 3) batch. Returns d or (d, gx, gy, gz)
    with the gradient in world units (trilinear-interpolant gradient plus
    the out-of-volume AABB term — the collision fast-normal).

    `d2`: the (W, S*H) bf16 operand from `_packed_volume` — passed in so
    chunked callers compute it ONCE outside their lax.map."""
    c = volume.config
    S, H, W = c.shape
    px, py, pz = pos_flat[:, 0], pos_flat[:, 1], pos_flat[:, 2]
    tx, ty, sp, (ux, uy, uz), (in_x, in_y, in_z) = _clamped_axes(
        volume, px, py, pz)

    bx = _interp_rows(tx, W, jnp.bfloat16)                     # (N, W)
    t1 = jax.lax.dot(bx, d2)                                   # (N, S*H)
    t1 = t1.reshape(-1, S, H)
    by = _interp_rows(ty, H, jnp.float32)                      # (N, H)
    bs = _interp_rows(sp, S, jnp.float32)                      # (N, S)
    d = jnp.einsum("nsh,ns,nh->n", t1, bs, by,
                   preferred_element_type=jnp.float32)

    dist2 = ux * ux + uy * uy + uz * uz
    dist = jnp.sqrt(dist2)
    out = d + dist
    if not want_grad:
        return out

    dbx = _deriv_rows(tx, W, jnp.bfloat16)
    t1x = jax.lax.dot(dbx, d2).reshape(-1, S, H)
    gx = jnp.einsum("nsh,ns,nh->n", t1x, bs, by,
                    preferred_element_type=jnp.float32) * c.scale_x
    dby = _deriv_rows(ty, H, jnp.float32)
    gy = jnp.einsum("nsh,ns,nh->n", t1, bs, dby,
                    preferred_element_type=jnp.float32) * c.scale_y
    dbs = _deriv_rows(sp, S, jnp.float32)
    gz = jnp.einsum("nsh,ns,nh->n", t1, dbs, by,
                    preferred_element_type=jnp.float32) * (
        c.slice_count / float(c.virtual_depth))
    gx = jnp.where(in_x, gx, 0.0)
    gy = jnp.where(in_y, gy, 0.0)
    gz = jnp.where(in_z, gz, 0.0)
    safe = jnp.maximum(dist, 1e-9)
    gx = gx + jnp.where(dist > 0.0, ux / safe, 0.0)
    gy = gy + jnp.where(dist > 0.0, uy / safe, 0.0)
    gz = gz + jnp.where(dist > 0.0, uz / safe, 0.0)
    return out, gx, gy, gz


# Chunk size for the matmul path: bounds the (chunk, S*H) intermediate
# while keeping each matmul large.
_INTERP_CHUNK = 1 << 15


def _packed_volume(volume: SdfVolume):
    """(W, S*H) bf16 matmul operand, computed once per sampled batch.

    Not wrapped in lax.optimization_barrier: the barrier keeps XLA from
    placing the operand once for every chunk and costs a relayout per
    chunk."""
    S, H, W = volume.config.shape
    return volume.data.reshape(S * H, W).T.astype(jnp.bfloat16)


def _chunked(volume, pos_flat, want_grad):
    n = pos_flat.shape[0]
    d2 = _packed_volume(volume)
    if n <= _INTERP_CHUNK:
        return _interp_core(volume, d2, pos_flat, want_grad)
    pad = (-n) % _INTERP_CHUNK
    p = jnp.pad(pos_flat, ((0, pad), (0, 0)))
    p = p.reshape(-1, _INTERP_CHUNK, 3)
    out = jax.lax.map(
        lambda q: _interp_core(volume, d2, q, want_grad), p)
    if want_grad:
        return tuple(o.reshape(-1)[:n] for o in out)
    return out.reshape(-1)[:n]


def sample_interp(volume: SdfVolume, position):
    """Matmul trilinear sample at world positions (..., 3) -> (...,).

    Matches `sample` to bf16 relative precision (see module docstring);
    use for scattered batches of >= ~16k points."""
    shape = position.shape[:-1]
    d = _chunked(volume, position.reshape(-1, 3), False)
    return d.reshape(shape)


def sample_interp_grad(volume: SdfVolume, position):
    """Matmul trilinear sample + world-space gradient of the interpolant
    (the collision fast normal; NOT the tetrahedral estimate_normal
    oracle — that stays the visualize-parity path).

    Returns (d, g) with g (..., 3) UN-normalized."""
    shape = position.shape[:-1]
    d, gx, gy, gz = _chunked(volume, position.reshape(-1, 3), True)
    g = jnp.stack([gx, gy, gz], axis=-1)
    return d.reshape(shape), g.reshape(shape + (3,))


def grid_stack(volume: SdfVolume, xs, ys,
               precision=jax.lax.Precision.HIGHEST):
    """Resample every slice onto the separable world grid (ys, xs).

    Returns (S, len(ys), len(xs)) f32 — exact bilinear-per-slice values
    at the grid points (two small interpolation-matrix matmuls per
    slice; no gathers). Feed to `sample_stack_z` for per-query z."""
    c = volume.config
    S, H, W = c.shape
    cx = jnp.clip(xs, 0.0, float(c.virtual_width))
    cy = jnp.clip(ys, 0.0, float(c.virtual_height))
    bx = _interp_rows(cx * c.scale_x - 0.5, W, jnp.float32)  # (W', W)
    by = _interp_rows(cy * c.scale_y - 0.5, H, jnp.float32)  # (H', H)
    t = jax.lax.dot_general(volume.data, bx, (((2,), (1,)), ((), ())),
                            precision=precision)             # (S, H, W')
    stack = jnp.einsum("shw,ph->spw", t, by, precision=precision)
    return stack


def sample_stack_z(volume: SdfVolume, stack, xs, ys, z):
    """Trilinear sample with xy pinned to a `grid_stack` grid and z free.

    `z` broadcasts against (..., len(ys), len(xs)); the slice lerp is an
    unrolled masked sum over S (16 FMAs per query — no gathers, exact).
    Adds the out-of-AABB distance for queries outside the volume in ANY
    axis (xs/ys outside contribute their separable terms)."""
    c = volume.config
    S = c.slice_count
    ez = float(c.virtual_depth)
    z = z - c.z_offset
    cz = jnp.clip(z, 0.0, ez)
    zc = jnp.minimum(cz, volume.max_valid_z)
    sp = jnp.minimum(zc * (S / ez), float(S - 1))

    d = jnp.zeros(jnp.broadcast_shapes(
        jnp.shape(sp), (len(ys), len(xs))), jnp.float32)
    for s in range(S):
        w = jnp.clip(1.0 - jnp.abs(sp - float(s)), 0.0, 1.0)
        d = d + w * stack[s]

    ux = jnp.minimum(xs, 0.0) + jnp.maximum(
        xs - float(c.virtual_width), 0.0)
    uy = jnp.minimum(ys, 0.0) + jnp.maximum(
        ys - float(c.virtual_height), 0.0)
    uz = jnp.minimum(z, 0.0) + jnp.maximum(z - ez, 0.0)
    dist = jnp.sqrt(ux[None, :] ** 2 + uy[:, None] ** 2 + uz * uz)
    return d + dist


def sample_grid(volume: SdfVolume, xs, ys, z):
    """Exact trilinear on a separable world grid: out (..., H', W').

    The occlusion-image shape: xs (W',), ys (H',), z scalar or
    broadcastable. Equals `sample` at the same points to matmul
    precision."""
    stack = grid_stack(volume, xs, ys)
    return sample_stack_z(volume, stack, xs, ys, z)
