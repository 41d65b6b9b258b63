"""Textured sprite rasterization: SVD-factored sprite tables.

The reference draws each particle as a TEXTURED quad with sprite-sheet
frame selection, rotation, and sizing (RasterizeParticleSystem.fx:62-144;
frame from AnimationRate / RowFromVelocity / ColumnFromVelocity,
ParticleConfiguration.cs:42-109). Texture sampling per covered pixel is a
gather, so the JAX-native form
factors every sprite VARIANT (frame x rotation bin x size bin) into a
rank-R SEPARABLE approximation by SVD on the host:

    sprite_b(dy, dx) ~= sum_r row_b[r, dy] * col_b[r, dx]

and the rasterizer becomes R one-hot matmul splats per tile, exactly like
the analytic kernels in tiled.py — selection of each particle's factors
is one small gather of 2*R*S values from a <=few-hundred-row table.

Quantization contract (all documented, all controllable):
  * rotation quantized to `angle_bins` (sprites are rotationally smooth;
    16 bins = 11 degrees);
  * size quantized to `size_bins` log-spaced steps in [size_min, size_max];
  * rank truncation error = sum of discarded singular values (the builder
    reports per-variant residuals; radial glows are rank 1-3).
The reference-exact per-pixel path remains raster/particles.py (oracle).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core.pytree import pytree_dataclass, static_field
from .tiled import (
    TiledRasterConfig,
    _overlap_add,
    _tile_origins,
    bin_particles,
    composite_over_tiles,
)


@pytree_dataclass
class SpriteTable:
    """Factored sprite variants.

    row_factors/col_factors: (B, R, S) f32 where B = frames *
    angle_bins * size_bins, R = rank, S = support (odd). Variant b covers
    a size-S pixel window centered on the particle.
    """

    row_factors: jnp.ndarray
    col_factors: jnp.ndarray
    frames: int = static_field(default=1)
    angle_bins: int = static_field(default=1)
    size_bins: int = static_field(default=1)
    size_min: float = static_field(default=1.0)
    size_max: float = static_field(default=8.0)
    residual: float = static_field(default=0.0)

    @property
    def rank(self) -> int:
        return self.row_factors.shape[1]

    @property
    def support(self) -> int:
        return self.row_factors.shape[2]


def _render_variant(tex: np.ndarray, angle: float, size: float,
                    support: int, oversample: int = 4) -> np.ndarray:
    """Rasterize one sprite variant (rotated, scaled) onto an S x S grid
    on the host — box-filtered by supersampling (the quad edge AA the
    GPU rasterizer produces)."""
    s = support
    os_ = oversample
    # Sample positions relative to the sprite center, pixel centers.
    coords = (np.arange(s * os_) + 0.5) / os_ - s / 2.0
    dy, dx = np.meshgrid(coords, coords, indexing="ij")
    ca, sa = np.cos(-angle), np.sin(-angle)
    u = (dx * ca - dy * sa) / size + 0.5  # sprite-local [0,1]
    v = (dx * sa + dy * ca) / size + 0.5
    th, tw = tex.shape[:2]
    inside = (u >= 0) & (u < 1) & (v >= 0) & (v < 1)
    ti = np.clip((v * th).astype(np.int64), 0, th - 1)
    tj = np.clip((u * tw).astype(np.int64), 0, tw - 1)
    val = tex[ti, tj] * inside
    # Box-filter down to S x S.
    val = val.reshape(s, os_, s, os_).mean(axis=(1, 3))
    return val.astype(np.float32)


def build_sprite_table(
    texture: np.ndarray,
    frames_x: int = 1,
    frames_y: int = 1,
    angle_bins: int = 1,
    size_bins: int = 4,
    rank: int = 3,
    size_min: float = 2.0,
    size_max: float = 12.0,
    support: Optional[int] = None,
) -> SpriteTable:
    """Factor a sprite sheet into a SpriteTable (host-side SVD).

    `texture`: (H, W) or (H, W, C) — C > 1 uses the alpha/last channel as
    the sprite intensity (the color modulation happens per particle).
    """
    tex = np.asarray(texture, np.float32)
    if tex.ndim == 3:
        tex = tex[..., -1]
    frames = frames_x * frames_y
    fh = tex.shape[0] // frames_y
    fw = tex.shape[1] // frames_x
    if support is None:
        support = int(np.ceil(size_max)) | 1  # odd
    s = support

    n_variants = frames * angle_bins * size_bins
    if n_variants > 256:
        raise ValueError(
            f"frames*angle_bins*size_bins = {n_variants} > 256: variant "
            "ids ride a bf16 payload lane, exact only to 256 — reduce "
            "bins or split the sheet into multiple tables"
        )
    sizes = np.exp(np.linspace(np.log(size_min), np.log(size_max),
                               size_bins))
    rows = np.zeros((frames * angle_bins * size_bins, rank, s), np.float32)
    cols = np.zeros_like(rows)
    worst = 0.0
    b = 0
    for f in range(frames):
        fy, fx = divmod(f, frames_x)
        frame_tex = tex[fy * fh:(fy + 1) * fh, fx * fw:(fx + 1) * fw]
        for a in range(angle_bins):
            angle = 2.0 * np.pi * a / angle_bins
            for si in range(size_bins):
                variant = _render_variant(frame_tex, angle, sizes[si], s)
                u, sv, vt = np.linalg.svd(variant)
                r = min(rank, len(sv))
                scale = np.sqrt(sv[:r])
                rows[b, :r] = (u[:, :r] * scale).T
                cols[b, :r] = vt[:r] * scale[:, None]
                total = np.linalg.norm(sv)
                worst = max(worst,
                            float(np.linalg.norm(sv[r:]) /
                                  max(total, 1e-9)))
                b += 1
    return SpriteTable(
        row_factors=jnp.asarray(rows),
        col_factors=jnp.asarray(cols),
        frames=frames,
        angle_bins=angle_bins,
        size_bins=size_bins,
        size_min=float(size_min),
        size_max=float(size_max),
        residual=worst,
    )


def circular_alpha(dist, power):
    """computeCircularAlpha (RasterizeParticleSystem.fx:144-156): `dist`
    is the normalized quad-local distance (1.0 at the inscribed circle's
    edge), `power` the rounding power (RoundingPowerFromLife,
    ParticleConfiguration.cs:82, clamped [0.001, 1] by the VS fx:139-141
    then floored at 0.01 in the PS). NumPy/JAX-polymorphic."""
    xp = jnp if isinstance(dist, jnp.ndarray) else np
    p = xp.maximum(xp.clip(power, 0.001, 1.0), 0.01)
    divisor = xp.maximum(xp.clip(1.0 - p, 0.0, 1.0), 0.001)
    dfe = xp.clip(dist - p, 0.0, 1.0) / divisor
    return xp.clip(1.0 - dfe ** p, 0.0, 1.0)


def build_power_disc_table(
    powers,
    size_min: float = 2.0,
    size_max: float = 12.0,
    size_bins: int = 4,
    rank: int = 3,
    support: Optional[int] = None,
    cell: int = 128,
) -> SpriteTable:
    """Procedural rounded-disc sprite table whose FRAME axis is the
    rounding power (RoundingPowerFromLife animation): frame i is the
    exact radial computeCircularAlpha profile at powers[i], box-filtered
    onto the variant grid like any sprite. Rotationally symmetric ->
    angle_bins 1; radial profiles factor at low rank. The per-particle
    frame is selected from the evaluated power bezier
    (render.py render_particles)."""
    frames = []
    coords = ((np.arange(cell) + 0.5) / cell) * 2.0 - 1.0
    dyy, dxx = np.meshgrid(coords, coords, indexing="ij")
    dist = np.sqrt(dxx * dxx + dyy * dyy)
    for p in powers:
        frames.append(circular_alpha(dist, float(p)).astype(np.float32))
    tex = np.concatenate(frames, axis=0)  # vertical frame stack
    return build_sprite_table(
        tex, frames_x=1, frames_y=len(frames), angle_bins=1,
        size_bins=size_bins, rank=rank, size_min=size_min,
        size_max=size_max, support=support,
    )


def select_bins(table: SpriteTable, frame, angle, size):
    """Per-particle variant index from (frame, rotation, size)."""
    fi = jnp.clip(frame.astype(jnp.int32), 0, table.frames - 1)
    two_pi = 2.0 * jnp.pi
    ai = jnp.mod(
        jnp.round(angle / two_pi * table.angle_bins).astype(jnp.int32),
        table.angle_bins,
    )
    logs = jnp.log(jnp.clip(size, table.size_min, table.size_max)
                   / table.size_min)
    log_span = float(np.log(table.size_max / table.size_min))
    si = jnp.clip(
        jnp.round(
            logs / max(log_span, 1e-9) * (table.size_bins - 1)
        ).astype(jnp.int32),
        0, table.size_bins - 1,
    )
    return (fi * table.angle_bins + ai) * table.size_bins + si


def animation_frame(table: SpriteTable, life, velocity,
                    animation_rate: Tuple[float, float] = (0.0, 0.0),
                    row_from_velocity: bool = False,
                    column_from_velocity: bool = False,
                    frames_x: int = 1):
    """Sprite-sheet frame selection (ParticleConfiguration.cs:42-109 +
    RasterizeParticleSystem.fx frame math): AnimationRate advances the
    frame with life; Row/ColumnFromVelocity picks the row/column from the
    velocity angle."""
    frames = table.frames
    frames_y = max(frames // max(frames_x, 1), 1)
    fx = jnp.zeros_like(life)
    fy = jnp.zeros_like(life)
    if animation_rate[0]:
        fx = jnp.floor(life * animation_rate[0])
    if animation_rate[1]:
        fy = jnp.floor(life * animation_rate[1])
    angle = jnp.arctan2(velocity[:, 1], velocity[:, 0])
    turns = jnp.mod(angle / (2.0 * jnp.pi) + 1.0, 1.0)
    if column_from_velocity:
        fx = jnp.floor(turns * frames_x)
    if row_from_velocity:
        fy = jnp.floor(turns * frames_y)
    return jnp.mod(fy * frames_x + fx, frames).astype(jnp.int32)


def _sprite_bins_and_factors(cfg, table, x, y, color, size, live,
                             rotation, frame, replicate=False):
    """Shared front half of both sprite paths: bin particles (variant id
    riding the size operand) and build the per-rank separable coverage
    factors wy_r (NT, win, K) / wx_r (NT, K, win) via S static
    shift-selects with subpixel lerp."""
    s = table.support
    half = s // 2
    assert cfg.apron >= half, (
        f"apron {cfg.apron} < sprite support half-width {half}"
    )
    assert not cfg.compact_payload, (
        "sprite path carries the variant id in the size operand — "
        "incompatible with the log-quantized compact payload"
    )
    r_rank = table.rank
    win = cfg.window
    k = cfg.bin_capacity

    # Bin like the analytic path, but carry (frame, angle) in the size
    # operand's spare bf16 lane: pack angle into size operand.
    rot = rotation if rotation is not None else jnp.zeros_like(x)
    frm = frame if frame is not None else jnp.zeros_like(x)
    # Encode variant bin id (fits bf16 exactly for B <= 256).
    bin_id = select_bins(table, frm, rot, size)
    # The alpha path replicates each sprite into every tile its support
    # touches (tile-exclusive compositing; see bin_particles); the
    # support radius comes from the REAL size, not the bin id riding
    # the size operand. table.support bounds the rendered half-width.
    bins = bin_particles(cfg, x, y, color, bin_id.astype(jnp.float32),
                         live, replicate_footprint=replicate,
                         replicate_radius=jnp.minimum(
                             size, 2.0 * table.support))
    nt = bins["valid"].shape[0]
    bsel = jnp.clip(bins["size"].astype(jnp.int32), 0,
                    table.row_factors.shape[0] - 1)  # (NT, K)

    # Factor lookup: one gather of 2*R*S values per slot.
    fac = jnp.concatenate(
        [table.row_factors.reshape(-1, r_rank * s),
         table.col_factors.reshape(-1, r_rank * s)], axis=-1
    )  # (B, 2*R*S)
    sel = jnp.take(fac, bsel.reshape(-1), axis=0).reshape(
        nt, k, 2, r_rank, s
    )
    row_f = sel[:, :, 0]  # (NT, K, R, S)
    col_f = sel[:, :, 1]

    # Window-local integer positions + subpixel fractions. Continuous
    # convention matches the analytic path and the per-pixel oracle:
    # pixel i's center sits at i + 0.5 (tiled.py ry/rx + 0.5;
    # particles.py fx = x - (xc + 0.5)) — so a particle at x = i + 0.5
    # is exactly centered on pixel i (variant sample F[half]).
    ox, oy = _tile_origins(cfg)
    px = bins["x"] - ox[:, None] + cfg.apron - 0.5
    py = bins["y"] - oy[:, None] + cfg.apron - 0.5
    ix = jnp.floor(px)
    iy = jnp.floor(py)
    fx = px - ix
    fy = py - iy

    ry = jnp.arange(win, dtype=jnp.float32)[None, :, None]  # (1, win, 1)
    rx = jnp.arange(win, dtype=jnp.float32)[None, None, :]

    wys, wxs = [], []
    for r in range(r_rank):
        wy = jnp.zeros((nt, win, k), jnp.bfloat16)
        wx = jnp.zeros((nt, k, win), jnp.bfloat16)
        dy = ry - iy[:, None, :]  # (NT, win, K): y - iy
        dx = rx - ix[:, :, None]  # (NT, K, win)
        for si in range(s):
            off = si - half
            # F(y - py) sampled at integer y: index si when y - iy =
            # off (+1 for the fractional lerp neighbour).
            wsel_y = (dy == off).astype(jnp.float32)
            wsel_y1 = (dy == off + 1).astype(jnp.float32)
            contrib_y = (
                wsel_y * (1.0 - fy[:, None, :])
                + wsel_y1 * fy[:, None, :]
            ) * row_f[:, :, r, si][:, None, :]
            wy = wy + contrib_y.astype(jnp.bfloat16)
            wsel_x = (dx == off).astype(jnp.float32)
            wsel_x1 = (dx == off + 1).astype(jnp.float32)
            contrib_x = (
                wsel_x * (1.0 - fx[:, :, None])
                + wsel_x1 * fx[:, :, None]
            ) * col_f[:, :, r, si][:, :, None]
            wx = wx + contrib_x.astype(jnp.bfloat16)
        wys.append(wy)
        wxs.append(wx)
    return bins, wys, wxs


def rasterize_sprites(
    cfg: TiledRasterConfig,
    table: SpriteTable,
    x, y, color, size, live,
    rotation=None,
    frame=None,
):
    """Additive textured-sprite rasterization -> (H, W, C).

    Costs ~R x the analytic tiled splat plus one small table gather per
    bin slot; intended for textured systems (typically <= a few hundred
    thousand particles). cfg.apron must be >= support // 2.
    """
    ch = cfg.channels
    win = cfg.window
    k = cfg.bin_capacity
    bins, wys, wxs = _sprite_bins_and_factors(
        cfg, table, x, y, color, size, live, rotation, frame
    )
    nt = bins["valid"].shape[0]
    valid = bins["valid"]

    pc = jnp.stack(
        [bins["color"][c] * valid for c in range(ch)], axis=-1
    ).astype(jnp.bfloat16)

    tiles = jnp.zeros((nt, win, win * ch), jnp.float32)
    for wy, wx in zip(wys, wxs):
        rhs = (wx[:, :, :, None] * pc[:, :, None, :]).reshape(
            nt, k, win * ch)
        tiles = tiles + jnp.einsum(
            "twk,tkv->twv", wy, rhs, preferred_element_type=jnp.float32
        )

    img = _overlap_add(cfg, tiles)
    return img, dict(dropped=bins["dropped"], residual=table.residual)


def rasterize_sprites_alpha(
    cfg: TiledRasterConfig,
    table: SpriteTable,
    x, y, color, size, live,
    rotation=None,
    frame=None,
    background=None,
    dither: bool = False,
):
    """Ordered 'over' compositing of TEXTURED sprites -> (H, W, 4).

    The textured ordered-alpha path of RasterizeParticleSystem.fx
    (fx:62-237 with the Texture* materials, ParticleMaterials.cs:7-25):
    per tile, bin slots composite in draw order via lax.scan exactly like
    rasterize_tiled_alpha, but each slot's coverage is its sprite
    variant's rank-R separable reconstruction sum_r wy_r ⊗ wx_r evaluated
    at the slot's subpixel position. The sprite's texel value acts as
    per-pixel opacity modulation (texture alpha x particle alpha), the
    particle color as the straight source color. `color` premultiplied;
    `dither` applies the Bayer discard (fx:158-175).

    O(bin_capacity) sequential per tile like the analytic alpha path.
    """
    assert cfg.channels == 4, "alpha compositing needs 4 channels"
    bins, wys, wxs = _sprite_bins_and_factors(
        cfg, table, x, y, color, size, live, rotation, frame,
        replicate=True,
    )
    valid = bins["valid"]
    cb = [c * valid for c in bins["color"]]  # planar premult channels
    # Stack ranks once: (R, NT, win, K) / (R, NT, K, win) — the scan body
    # slices slot j from every rank.
    wy_all = jnp.stack(wys, axis=0).astype(jnp.float32)
    wx_all = jnp.stack(wxs, axis=0).astype(jnp.float32)

    def coverage(j):
        # Slot j's sprite coverage: sum_r wy_r[:, :, j] ⊗ wx_r[:, j, :].
        cov = jnp.einsum(
            "rtw,rtv->twv", wy_all[:, :, :, j], wx_all[:, :, j, :]
        )
        # SVD ringing can push the reconstruction slightly out of [0, 1].
        return jnp.clip(cov, 0.0, 1.0)

    img = composite_over_tiles(cfg, cb, coverage, background, dither)
    return img, dict(dropped=bins["dropped"], residual=table.residual)


# Convenience jitted aliases (see scan_shadows.scan_visibility_jit).
rasterize_sprites_jit = jax.jit(
    rasterize_sprites, static_argnames=("cfg",))
rasterize_sprites_alpha_jit = jax.jit(
    rasterize_sprites_alpha, static_argnames=("cfg", "dither"))
