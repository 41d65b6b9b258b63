"""Tiled particle rasterizer — the JAX-native RasterizeParticleSystem.

Re-expresses the reference's instanced-quad rasterization
(/root/reference/Illuminant/Shaders/RasterizeParticleSystem.fx:62-237 —
VS reads state textures per instance, computes the sprite quad with Z
formula / sprite-sheet frame / rotation; PS applies texture x color,
circular rounding `computeCircularAlpha` fx:145-156, stipple fx:101-110,
dithered opacity fx:158-175) for hardware with no ROPs.

The pipeline: bin by screen tile (ONE multi-operand `lax.sort` by tile
id) -> slice fixed-capacity per-tile bins -> evaluate separable coverage
profiles per slot -> splat every tile as TWO one-hot bilinear matmuls ->
overlap-add the
tile windows (apron handles footprints crossing tile edges).

Coverage profiles are SEPARABLE row x column factors:
  - KERNEL_POINT: bilinear 2-tap (subpixel point splat) — exact.
  - KERNEL_QUAD: the reference's non-rounded quad — axis-separable
    box-filtered box coverage, exact per-axis antialiasing.
  - KERNEL_GAUSS: normalized Gaussian glow (sigma = radius/2).
  - KERNEL_ROUND: separable approximation of computeCircularAlpha
    (product of two smooth 1D edge profiles — a rounded square whose
    max deviation from the exact disc is at the diagonals; the exact
    disc path is raster/particles.py:rasterize_additive, kept as the
    oracle, and sprite tables below recover the disc to rank-R).
Textured sprites (sprite sheets, rotation) factor through rank-R SVD
profile tables — see sprites.py.

Blending:
  - additive: order-invariant accumulate (what every benchmark config
    and most Lumined scenes use).
  - alpha ('over'): per-tile ordered compositing via lax.scan over bin
    slots. The sort is stable, so slot order == state order == the
    reference's draw order (ParticleSystem.cs:876-909 draws slots in
    index order).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

KERNEL_POINT = "point"
KERNEL_QUAD = "quad"
KERNEL_GAUSS = "gauss"
KERNEL_ROUND = "round"

@dataclasses.dataclass(frozen=True)
class TiledRasterConfig:
    """Static rasterizer parameters (recompile on change)."""

    height: int
    width: int
    tile: int = 32
    # Per-tile bin capacity. Particles beyond it in one tile are dropped
    # (the returned diagnostics count them); raise for clustered scenes.
    bin_capacity: int = 1024
    # Apron in pixels: how far a footprint may reach past its tile.
    # Window = tile + 2 * apron; radii are clamped to apron + 0.5.
    apron: int = 4
    kernel: str = KERNEL_GAUSS
    # Quantize colors to rgba8 x scale through the sort (halves sort +
    # bin traffic; additive sums of hundreds of particles per tile wash
    # the quantization out). f32 mode keeps two bf16-pair operands.
    rgba8_colors: bool = True
    color_scale: float = 4.0  # rgba8 full-scale in HDR units
    # Stipple phase offset (per-system so stippled systems interleave).
    stipple_offset: float = 0.0
    # Output channel count: 4 = premultiplied RGBA; 3 = RGB only (the
    # flagship's additive HDR composite never reads particle alpha, and
    # dropping it cuts the splat's dominant rhs materialization by 25%).
    channels: int = 4
    # Hierarchical overflow: the M hottest tiles get a second K-slot bin
    # level (additive path only). 0 disables.
    overflow_tiles: int = 128
    # Sorted slots packed per gathered row (the XLA gather is row-count-
    # bound, so more slots/row = cheaper binning; alignment cost is only
    # paid by the ordered alpha path). 4 or 8.
    slots_per_row: int = 4
    # Compact payload: the SORT KEY ITSELF carries the position — bits
    # (ty:6 tx:6 y_local:9 x_local:9) where locals are 1/8-px offsets in
    # [-32, +32) around the tile origin (covers the apron) — and the
    # single payload operand packs rgb888 + an 8-bit log size. Sorting by
    # this key orders by tile id first (what binning needs); the in-tile
    # order is by y then x, irrelevant for additive blending. ONE key +
    # ONE operand through the sort. Requires channels == 3 (the alpha
    # byte holds the size) and rgba8 colors.
    compact_payload: bool = False
    # int8 splat (additive path): quantize the coverage factors and
    # the rhs (coverage x color) to s8 and contract s8 x s8 -> s32. The
    # splat is bandwidth-bound on operand materialization, so halving
    # operand bytes nearly halves it. Precision: coverage in
    # 1/127 steps, colors in color_scale/127 steps — additive sums of
    # many particles wash this out exactly like rgba8_colors.
    int8_splat: bool = False

    @property
    def grid(self) -> Tuple[int, int]:
        gy = -(-self.height // self.tile)
        gx = -(-self.width // self.tile)
        return gy, gx

    @property
    def window(self) -> int:
        return self.tile + 2 * self.apron


XY_SUBPIXEL = 16.0  # fixed-point position precision through the sort
_XY_BIAS = 2048

# Compact payload: position rides in the sort key (1/8-px tile-local
# coords; 9-bit codes with bias 64 cover [-8, +56) px around the tile
# origin — enough for tile + apron on both sides); size is an 8-bit log
# code in the payload's alpha byte.
_C_SUB = 8.0
_C_LBIAS = 64
_C_SIZE_MIN = 0.5
_C_SIZE_MAX = 16.5
import math as _math  # noqa: E402

_C_SIZE_SPAN = _math.log(_C_SIZE_MAX / _C_SIZE_MIN)


def _pack_compact_key(tyi, txi, x, y, tile):
    xl = jnp.clip(
        jnp.round((x - txi.astype(jnp.float32) * tile) * _C_SUB
                  ).astype(jnp.int32) + _C_LBIAS, 0, 511)
    yl = jnp.clip(
        jnp.round((y - tyi.astype(jnp.float32) * tile) * _C_SUB
                  ).astype(jnp.int32) + _C_LBIAS, 0, 511)
    return (tyi << 24) | (txi << 18) | (yl << 9) | xl


def _unpack_compact_key(key, tile):
    tyi = (key >> 24) & 0x3F
    txi = (key >> 18) & 0x3F
    yl = (key >> 9) & 0x1FF
    xl = key & 0x1FF
    x = (txi * tile + (xl - _C_LBIAS).astype(jnp.float32) / _C_SUB)
    y = (tyi * tile + (yl - _C_LBIAS).astype(jnp.float32) / _C_SUB)
    return x, y


def _pack_rgb_size(color, scale, size):
    c = jnp.clip(color[:, :3] / scale * 255.0 + 0.5, 0.0, 255.0
                 ).astype(jnp.int32)
    si = jnp.clip(
        jnp.round(jnp.log(jnp.clip(size, _C_SIZE_MIN, _C_SIZE_MAX)
                          / _C_SIZE_MIN) / _C_SIZE_SPAN * 255.0
                  ).astype(jnp.int32),
        0, 255,
    )
    return c[:, 0] | (c[:, 1] << 8) | (c[:, 2] << 16) | (si << 24)


def _unpack_rgb_size(packed, scale):
    colors = tuple(
        ((packed >> (8 * c)) & 0xFF).astype(jnp.float32) * (scale / 255.0)
        for c in range(3)
    )
    si = (packed >> 24) & 0xFF
    size = _C_SIZE_MIN * jnp.exp(
        si.astype(jnp.float32) * (_C_SIZE_SPAN / 255.0))
    return colors, size


def quantize_xy(x, y):
    """The position quantization the packed payload applies (1/16 px,
    round-to-nearest). Exposed so oracles can match it exactly."""
    q = 1.0 / XY_SUBPIXEL
    return jnp.round(x * XY_SUBPIXEL) * q, jnp.round(y * XY_SUBPIXEL) * q


def _pack_xy(x, y):
    """Pack screen coords as 2x16-bit fixed point (4 fractional bits).
    Range: [-128, +3967] px around the viewport (off-screen culled)."""
    xi = jnp.clip(jnp.round(x * XY_SUBPIXEL).astype(jnp.int32) + _XY_BIAS,
                  0, 65535)
    yi = jnp.clip(jnp.round(y * XY_SUBPIXEL).astype(jnp.int32) + _XY_BIAS,
                  0, 65535)
    return (xi << 16) | yi


def _unpack_xy(packed):
    xi = (packed >> 16) & 0xFFFF
    yi = packed & 0xFFFF
    return ((xi - _XY_BIAS).astype(jnp.float32) / XY_SUBPIXEL,
            (yi - _XY_BIAS).astype(jnp.float32) / XY_SUBPIXEL)


def _pack_rgba8(color, scale):
    c = jnp.clip(color / scale * 255.0 + 0.5, 0.0, 255.0).astype(jnp.int32)
    return c[:, 0] | (c[:, 1] << 8) | (c[:, 2] << 16) | (c[:, 3] << 24)


def _unpack_rgba8(packed, scale):
    r = (packed >> 0) & 0xFF
    g = (packed >> 8) & 0xFF
    b = (packed >> 16) & 0xFF
    a = (packed >> 24) & 0xFF
    c = jnp.stack([r, g, b, a], axis=-1).astype(jnp.float32)
    return c * (scale / 255.0)


def _pack_bf16_pair(a, b):
    pair = jnp.stack([a.astype(jnp.bfloat16), b.astype(jnp.bfloat16)],
                     axis=-1)
    return lax.bitcast_convert_type(pair, jnp.int32)


def _unpack_bf16_pair(packed):
    pair = lax.bitcast_convert_type(packed, jnp.bfloat16)
    return (pair[..., 0].astype(jnp.float32),
            pair[..., 1].astype(jnp.float32))


def _profile(kernel: str, d, radius):
    """1-D coverage factor at signed distance d from the center.

    Separable row/column profiles; the 2-D footprint is their product.
    """
    if kernel == KERNEL_POINT:
        return jnp.clip(1.0 - jnp.abs(d), 0.0, 1.0)
    if kernel == KERNEL_QUAD:
        # Box-filtered box: pixel-center coverage of a width-2r box,
        # the exact separable form of the reference quad's edge.
        return jnp.clip(radius - jnp.abs(d) + 0.5, 0.0, 1.0)
    if kernel == KERNEL_GAUSS:
        # sigma = r/2; normalized so total energy ~ quad of equal radius.
        # exp(-q) via the squaring chain (1 - q/8)^8: the profile tensors
        # are (NT, WIN, K) ~ 84M elements each and a true exp there is
        # a transcendental per element; the chain is 5 multiplies
        # and within 6% of e^-q over the visible range (coverage is an
        # 8-bit-ish quantity), with exact compact support beyond q=8.
        sigma = jnp.maximum(radius * 0.5, 0.3)
        q = 0.5 * (d / sigma) ** 2
        base = jnp.maximum(1.0 - q * 0.125, 0.0)
        b2 = base * base
        b4 = b2 * b2
        return b4 * b4
    if kernel == KERNEL_ROUND:
        # Smooth edge whose product approximates the circular alpha
        # 1 - saturate(dist - radius + 0.5) (fx:145-156). The sqrt term
        # makes the product of the two axis factors equal the exact
        # value on the axes; corners are slightly over-covered. The
        # sqrt(1 - u/2), u = edge^2 in [0, 1], is evaluated as its
        # least-squares quadratic (max |err| 9.7e-4 — under 1/4 LSB of
        # 8-bit coverage): the profile tensors are (NT, WIN, K) ~84M
        # elements each, so a real sqrt there is a measurable
        # transcendental cost per frame.
        t = jnp.clip(radius - jnp.abs(d) + 0.5, 0.0, 1.0)
        edge = jnp.clip(jnp.abs(d) / jnp.maximum(radius, 0.5), 0.0, 1.0)
        u = edge * edge
        return t * (0.99924356 - (0.24155038 + 0.04961871 * u) * u)
    raise ValueError(f"unknown kernel {kernel!r}")


def bin_particles(cfg: TiledRasterConfig, x, y, color, size, live,
                  aligned: bool = True, stable: bool = True,
                  replicate_footprint: bool = False,
                  replicate_radius=None):
    """Sort by tile, slice per-tile bins.

    Returns a dict with per-slot arrays (x/y/color/size), the valid mask,
    drop count, and the quad-row payload for overflow passes. With
    aligned=False the slot axis is K + slots_per_row wide and unordered
    (see _quad_gather) — only valid for order-invariant consumers.
    `stable=False` picks XLA's cheaper unstable sort — ties (same
    quantized key) then land in
    arbitrary slot order, fine for additive accumulation only.

    `replicate_footprint=True` bins each particle into EVERY tile its
    coverage support overlaps (up to 2x2 — support radius <= apron+1 <=
    tile): the ordered-alpha path composites each tile's own pixels
    against ALL particles that touch them and reassembles tile-exclusive
    regions (summing independently composited apron overlaps would ADD
    where cross-tile particles overlap instead of 'over'-compositing
    them). Candidates are laid out particle-major so the stable sort
    preserves draw order inside every tile. 4x sort entries — for the
    (typically small) alpha systems only.
    """
    gy, gx = cfg.grid
    nt = gy * gx
    k = cfg.bin_capacity

    onscreen = (
        (x > -(cfg.apron + 1.0)) & (x < cfg.width + cfg.apron + 1.0)
        & (y > -(cfg.apron + 1.0)) & (y < cfg.height + cfg.apron + 1.0)
    )
    if replicate_footprint:
        assert not cfg.compact_payload
        # Support radius; `replicate_radius` overrides when the size
        # operand carries something else (the sprite path packs the
        # variant bin id there).
        r_base = size if replicate_radius is None else replicate_radius
        r_sup = jnp.clip(r_base * 0.5, 0.5, cfg.apron + 0.5) + 0.5
        txa = jnp.clip(((x - r_sup) / cfg.tile).astype(jnp.int32),
                       0, gx - 1)
        txb = jnp.clip(((x + r_sup) / cfg.tile).astype(jnp.int32),
                       0, gx - 1)
        tya = jnp.clip(((y - r_sup) / cfg.tile).astype(jnp.int32),
                       0, gy - 1)
        tyb = jnp.clip(((y + r_sup) / cfg.tile).astype(jnp.int32),
                       0, gy - 1)
        keys = []
        base_ok = live & onscreen
        for cy, cx in ((0, 0), (0, 1), (1, 0), (1, 1)):
            tx = txb if cx else txa
            ty = tyb if cy else tya
            ok = base_ok
            if cx:
                ok = ok & (txb > txa)
            if cy:
                ok = ok & (tyb > tya)
            keys.append(jnp.where(ok, ty * gx + tx, nt))
        # Particle-major layout: candidate axis minor, so the stable
        # sort keeps particle-index (draw) order within each tile.
        key = jnp.stack(keys, axis=1).reshape(-1)
        rep = 4
        x = jnp.repeat(x, rep)
        y = jnp.repeat(y, rep)
        size = jnp.repeat(size, rep)
        color = jnp.repeat(color, rep, axis=0)
    else:
        txi = jnp.clip((x / cfg.tile).astype(jnp.int32), 0, gx - 1)
        tyi = jnp.clip((y / cfg.tile).astype(jnp.int32), 0, gy - 1)
        key = jnp.where(live & onscreen, tyi * gx + txi, nt)
    n = x.shape[0]

    if cfg.compact_payload:
        assert cfg.rgba8_colors and cfg.channels == 3, (
            "compact payload packs rgb888+size8 — requires rgba8 colors "
            "and channels == 3"
        )
        # The 9-bit tile-local codes cover [-_C_LBIAS/_C_SUB,
        # (511-_C_LBIAS)/_C_SUB) px around the tile origin; larger
        # tile+apron would silently clamp positions. Same for the log
        # size code's ceiling vs the radius clamp (apron + 0.5 -> sizes
        # up to 2*apron + 1).
        assert cfg.tile + cfg.apron <= (511 - _C_LBIAS) / _C_SUB, (
            "compact payload: tile + apron exceeds the 9-bit coordinate "
            "range")
        assert 2 * cfg.apron + 1 <= _C_SIZE_MAX, (
            "compact payload: apron admits sizes above the log-code "
            "ceiling")
        key = jnp.where(
            live & onscreen,
            _pack_compact_key(tyi, txi, x, y, cfg.tile),
            jnp.int32(0x7FFFFFFF),
        )
        ops = [_pack_rgb_size(color, cfg.color_scale, size)]
    else:
        ops = [_pack_xy(x, y)]
        if cfg.rgba8_colors:
            ops.append(_pack_rgba8(color, cfg.color_scale))
            ops.append(_pack_bf16_pair(size, jnp.zeros_like(size)))
        elif cfg.channels == 3:
            # bf16 colors without alpha: (r,g) + (b,size) — one fewer
            # operand through the sort than the rgba layout (additive
            # composites never read particle alpha; the parity-preset
            # flagship raster takes this layout).
            ops.append(_pack_bf16_pair(color[:, 0], color[:, 1]))
            ops.append(_pack_bf16_pair(color[:, 2], size))
        else:
            ops.append(_pack_bf16_pair(color[:, 0], color[:, 1]))
            ops.append(_pack_bf16_pair(color[:, 2], color[:, 3]))
            ops.append(_pack_bf16_pair(size, jnp.zeros_like(size)))

    sorted_all = lax.sort((key, *ops), num_keys=1, is_stable=stable)
    skey = sorted_all[0]

    if cfg.compact_payload:
        # Fused keys order lexicographically by (ty, tx) — same order as
        # tile ids (gx <= 64) — with tile t's keys in
        # [(ty<<24)|(tx<<18), next tile). Query those lower bounds.
        assert gx <= 64 and gy <= 64, "compact payload: grid <= 64x64"
        tids = jnp.arange(nt + 1, dtype=jnp.int32)
        t_ty = jnp.minimum(tids // gx, gy - 1)
        t_tx = tids % gx
        bounds = jnp.where(
            tids < nt, (t_ty << 24) | (t_tx << 18),
            jnp.int32(0x7FFFFFFF),
        )
        starts = jnp.searchsorted(skey, bounds).astype(jnp.int32)
    else:
        starts = jnp.searchsorted(
            skey, jnp.arange(nt + 1, dtype=jnp.int32)
        ).astype(jnp.int32)
    counts = starts[1:] - starts[:-1]  # (NT,)
    dropped = jnp.sum(jnp.maximum(counts - k, 0))

    # Multi-slot-row bin gather: pack `spr` sorted slots per gathered row
    # and realign per tile — this divides the number of gathered rows by
    # spr. Each operand keeps its own contiguous slot blocks,
    # concatenated side by side (a (N, P) stack would interleave a
    # narrow minor dim); the payload is padded by a full window so base_row =
    # starts // spr never clamps and the in-row offset is in [0, spr).
    # In compact mode the sorted KEY carries the position, so it is part
    # of the gathered payload.
    payload_ops = sorted_all if cfg.compact_payload else sorted_all[1:]
    p = len(payload_ops)
    spr = cfg.slots_per_row
    # ceil(k/spr) + 1 rows: the +1 absorbs the in-row offset (up to
    # spr-1); plain k//spr + 1 under-covers when k % spr > 1 (off + k can
    # exceed the window — silently truncating near-full bins in unaligned
    # mode, or a trace-time broadcast error in aligned mode).
    rows_needed = -(-k // spr) + 1
    n_rows = -(-n // spr) + rows_needed
    pad = n_rows * spr - n
    packed = jnp.concatenate(
        [jnp.pad(op, (0, pad)).reshape(n_rows, spr)
         for op in payload_ops],
        axis=1,
    )  # (n_rows, spr*P): columns [spr*i, spr*(i+1)) = operand i's slots

    bins, valid = _quad_gather(packed, starts[:-1], counts, k, p,
                               aligned=aligned, spr=spr)
    unpacked = _unpack_bins(cfg, bins)
    unpacked.update(valid=valid, dropped=dropped, packed=packed,
                    starts=starts[:-1], counts=counts)
    return unpacked


def _quad_gather(packed, starts_sel, counts_sel, k, p, aligned=True,
                 spr=4):
    """Gather K (+spr when unaligned) slots per selected segment from the
    multi-slot-row payload. starts_sel/counts_sel: (M,) segment starts/
    counts (absolute slot indices). Returns (bins: list of P (M, S) int32
    operand arrays, valid (M, S)).

    aligned=True shifts slots so bin j == sorted[start + j] (the alpha
    path needs draw order). aligned=False skips the realign selects and
    instead masks by ABSOLUTE slot position — additive blending is
    order-invariant, so the set is all that matters."""
    m = starts_sel.shape[0]
    rows_needed = -(-k // spr) + 1  # must match bin_particles' padding

    base_row = starts_sel // spr

    # Flat per-row gather, NOT vmap(dynamic_slice) of a (rows_needed,
    # spr*P) slice per segment.
    rows = base_row[:, None] + jnp.arange(rows_needed, dtype=jnp.int32)
    quad = jnp.take(packed, rows, axis=0)  # (M, rows_needed, spr*P)
    off = starts_sel - base_row * spr  # in [0, spr)
    bins = []
    for i in range(p):
        slots = quad[:, :, spr * i:spr * (i + 1)].reshape(
            m, rows_needed * spr)
        if aligned:
            out = slots[:, 0:k]
            for o in range(1, spr):
                out = jnp.where((off == o)[:, None],
                                slots[:, o:o + k], out)
        else:
            out = slots  # (M, K + spr) raw window
        bins.append(out)
    if aligned:
        slot = jnp.arange(k, dtype=jnp.int32)[None, :]
        valid = slot < jnp.minimum(counts_sel, k)[:, None]
    else:
        pos = base_row[:, None] * spr + jnp.arange(
            rows_needed * spr, dtype=jnp.int32)[None, :]
        valid = (pos >= starts_sel[:, None]) & (
            pos < (starts_sel + jnp.minimum(counts_sel, k))[:, None]
        )
    return bins, valid


def _unpack_bins(cfg: TiledRasterConfig, bins):
    if cfg.compact_payload:
        bx, by = _unpack_compact_key(bins[0], cfg.tile)
        bc3, bsize = _unpack_rgb_size(bins[1], cfg.color_scale)
        return dict(x=bx, y=by, color=bc3 + (jnp.zeros_like(bc3[0]),),
                    size=bsize)
    bx, by = _unpack_xy(bins[0])
    if cfg.rgba8_colors:
        packed = bins[1]
        scale = cfg.color_scale / 255.0
        # PLANAR channels — a (NT, K, 4) stack is a minor-dim-4
        # interleave.
        bc = tuple(
            ((packed >> (8 * c)) & 0xFF).astype(jnp.float32) * scale
            for c in range(4)
        )
        size_idx = 2
    elif cfg.channels == 3:
        c0, c1 = _unpack_bf16_pair(bins[1])
        c2, bsize = _unpack_bf16_pair(bins[2])
        return dict(x=bx, y=by, color=(c0, c1, c2, jnp.zeros_like(c0)),
                    size=bsize)
    else:
        c0, c1 = _unpack_bf16_pair(bins[1])
        c2, c3 = _unpack_bf16_pair(bins[2])
        bc = (c0, c1, c2, c3)
        size_idx = 3
    bsize, _ = _unpack_bf16_pair(bins[size_idx])
    return dict(x=bx, y=by, color=bc, size=bsize)


def _tile_origins(cfg: TiledRasterConfig):
    gy, gx = cfg.grid
    ids = jnp.arange(gy * gx, dtype=jnp.int32)
    ox = (ids % gx * cfg.tile).astype(jnp.float32)
    oy = (ids // gx * cfg.tile).astype(jnp.float32)
    return ox, oy


def _coverage_factors(cfg: TiledRasterConfig, bins, ox=None, oy=None):
    """Per-slot separable coverage factors over the tile window.

    Returns wy (NT, WIN, K) and wx (NT, K, WIN) in bf16 — these are the
    big materializations (NT*WIN*K elements each); the profile math runs
    f32 elementwise and narrows on store, which halves the splat's HBM
    traffic at no visible cost (coverage is an 8-bit-ish quantity).
    ox/oy override the tile origins (the overflow pass passes selected
    tiles' origins).
    """
    win = cfg.window
    if ox is None:
        ox, oy = _tile_origins(cfg)
    px = bins["x"] - ox[:, None] + cfg.apron  # window-local
    py = bins["y"] - oy[:, None] + cfg.apron
    radius = jnp.clip(bins["size"] * 0.5, 0.5, cfg.apron + 0.5)

    ry = jnp.arange(win, dtype=jnp.float32)[None, :, None] + 0.5
    rx = jnp.arange(win, dtype=jnp.float32)[None, None, :] + 0.5
    wy = _profile(cfg.kernel, ry - py[:, None, :], radius[:, None, :])
    wx = _profile(cfg.kernel, rx - px[:, :, None], radius[:, :, None])
    return wy.astype(jnp.bfloat16), wx.astype(jnp.bfloat16)


def _overlap_add(cfg: TiledRasterConfig, tiles):
    """(NT, WIN, WIN*C) tile windows -> (H, W, C) via chunked dense adds.

    Window of tile (ty, tx) covers absolute pixels
    [ty*T - A, ty*T + T + A) x [tx*T - A, tx*T + T + A); in apron-padded
    coordinates (+A) its origin is (ty*T, tx*T) — windows sit on a
    stride-T grid. Split each window into <= ceil(WIN/T)^2 chunks of at
    most T rows/cols: chunk (cy, cx) of every tile lands at a disjoint
    stride-T position, so each chunk set is ONE dense shifted add.
    """
    gy, gx = cfg.grid
    t, a, win = cfg.tile, cfg.apron, cfg.window
    ch = tiles.shape[-1] // win
    tiles = tiles.reshape(gy, gx, win, win, ch)
    nc = -(-win // t)
    canvas = None
    for cy in range(nc):
        rows = min(t, win - cy * t)
        for cx in range(nc):
            cols = min(t, win - cx * t)
            piece = tiles[:, :, cy * t:cy * t + rows,
                          cx * t:cx * t + cols, :]
            piece = jnp.pad(
                piece,
                ((0, 0), (0, 0), (0, t - rows), (0, t - cols), (0, 0)),
            )
            block = piece.transpose(0, 2, 1, 3, 4).reshape(
                gy * t, gx * t, ch)
            if canvas is None:
                # First (core) chunk fills the canvas directly — no
                # read-modify-write of a zero canvas.
                canvas = jnp.pad(
                    block,
                    ((0, nc * t), (0, nc * t), (0, 0)),
                )
            else:
                canvas = canvas.at[
                    cy * t:cy * t + gy * t, cx * t:cx * t + gx * t, :
                ].add(block)
    return canvas[a:a + cfg.height, a:a + cfg.width, :]


def rasterize_tiled(
    cfg: TiledRasterConfig,
    x, y, color, size, live,
    stipple_factor: float = 1.0,
):
    """Additive tiled rasterization.

    x, y: (N,) screen positions (any z-to-y projection applied by the
    caller — see raster/render.py). color: (N, 4) premultiplied HDR.
    size: (N,)
    quad edge in pixels. live: (N,) bool.

    Returns (image (H, W, 4) f32, diagnostics dict).
    """
    if not (isinstance(stipple_factor, float)
            and stipple_factor >= 1.0):
        # StippleReject (fx:101-110): deterministic per-slot fraction.
        # Applied whenever the factor is traced OR < 1, so an animated
        # factor stays a traced value (a static branch here made every
        # distinct stipple value recompile the whole raster graph).
        from ..ops.coords import stipple_keep

        live = live & stipple_keep(x.shape[0], stipple_factor,
                                   cfg.stipple_offset)

    bins = bin_particles(cfg, x, y, color, size, live, aligned=False,
                         stable=False)
    wy, wx = _coverage_factors(cfg, bins)

    valid = bins["valid"]
    ch = cfg.channels
    nt = wy.shape[0]
    k = valid.shape[1]  # K + slots_per_row in unaligned mode
    win = cfg.window
    gy, gx = cfg.grid

    # Channel-MAJOR rhs (v = c*win + x) built from planar color channels,
    # and an einsum emitting (gy, win, gx, v) directly — placement then
    # needs only reshapes, no transposes, and no ch-wide minor dims
    # anywhere (both are relayout copies).
    if cfg.int8_splat:
        assert cfg.rgba8_colors, (
            "int8 splat needs the bounded rgba8 color range "
            "(arbitrary f32 HDR would clip at color_scale)"
        )
        # s8 x s8 -> s32 matmul: operand bytes halve and the splat
        # is operand-bandwidth-bound (see TiledRasterConfig.int8_splat).
        rscale = 127.0 / max(cfg.color_scale, 1e-6)
        wy_q = jnp.round(wy.astype(jnp.float32) * 127.0).astype(jnp.int8)
        rhs_q = jnp.concatenate(
            [
                jnp.clip(
                    jnp.round(
                        wx.astype(jnp.float32)
                        * (bins["color"][c] * valid)[:, :, None] * rscale
                    ),
                    -127, 127,
                ).astype(jnp.int8)
                for c in range(ch)
            ],
            axis=-1,
        )
        tiles = jnp.einsum(
            "abwk,abkv->awbv",
            wy_q.reshape(gy, gx, win, k),
            rhs_q.reshape(gy, gx, k, ch * win),
            preferred_element_type=jnp.int32,
        ).astype(jnp.float32) * (1.0 / (127.0 * rscale))
    else:
        rhs = jnp.concatenate(
            [wx * (bins["color"][c] * valid).astype(jnp.bfloat16)
             [:, :, None] for c in range(ch)],
            axis=-1,
        )  # (NT, K, ch*win)
        tiles = jnp.einsum(
            "abwk,abkv->awbv",
            wy.reshape(gy, gx, win, k),
            rhs.reshape(gy, gx, k, ch * win),
            preferred_element_type=jnp.float32,
        )  # (gy, win, gx, ch*win)
    dropped = bins["dropped"]

    if cfg.overflow_tiles > 0:
        # Hierarchical overflow: the M hottest tiles get a SECOND K-slot
        # bin level (slots [K, 2K) of their sorted segments), splatted the
        # same way and placed back with a one-hot matmul. Clustered scenes
        # (attractor cores) stop dropping particles without doubling the
        # whole gather/splat.
        m = min(cfg.overflow_tiles, nt)
        counts = bins["counts"]
        overflow = jnp.maximum(counts - k, 0)
        _, sel = lax.top_k(overflow, m)  # (M,) tile ids
        sel_counts = jnp.maximum(counts[sel] - k, 0)
        sel_starts = bins["starts"][sel] + k
        n_ops = 2 if cfg.compact_payload else (
            3 if (cfg.rgba8_colors or cfg.channels == 3) else 4)
        bins2, valid2 = _quad_gather(bins["packed"], sel_starts,
                                     sel_counts, cfg.bin_capacity,
                                     n_ops, aligned=False,
                                     spr=cfg.slots_per_row)
        up2 = _unpack_bins(cfg, bins2)
        ox, oy = _tile_origins(cfg)
        wy2, wx2 = _coverage_factors(cfg, up2, ox[sel], oy[sel])
        rhs2 = jnp.concatenate(
            [wx2 * (up2["color"][c] * valid2).astype(jnp.bfloat16)
             [:, :, None] for c in range(ch)],
            axis=-1,
        )
        tiles2 = jnp.einsum(
            "mwk,mkv->mwv", wy2, rhs2,
            preferred_element_type=jnp.float32,
        )  # (M, win, ch*win)
        onehot = (
            sel[:, None, None]
            == (jnp.arange(gy, dtype=jnp.int32)[None, :, None] * gx
                + jnp.arange(gx, dtype=jnp.int32)[None, None, :])
        ).astype(jnp.float32)
        tiles = tiles + jnp.einsum(
            "mab,mwv->awbv", onehot, tiles2,
            preferred_element_type=jnp.float32,
        )
        handled = jnp.sum(jnp.minimum(overflow[sel], k))
        dropped = jnp.sum(overflow) - handled

    img = _overlap_add_gxv(cfg, tiles)
    return img, dict(dropped=dropped)


def _overlap_add_gxv(cfg: TiledRasterConfig, tiles):
    """(gy, WIN, gx, CH*WIN) channel-major tile windows -> (H, W, CH).

    Same stride-T overlap-add as _overlap_add, but the layout makes every
    chunk placement a pure pad+reshape (no transposes)."""
    gy, gx = cfg.grid
    t, a, win = cfg.tile, cfg.apron, cfg.window
    ch = tiles.shape[-1] // win
    nc = -(-win // t)
    planes = []
    for c in range(ch):
        canvas = None
        for cy in range(nc):
            rows = min(t, win - cy * t)
            for cx in range(nc):
                cols = min(t, win - cx * t)
                piece = tiles[:, cy * t:cy * t + rows, :,
                              c * win + cx * t:c * win + cx * t + cols]
                piece = jnp.pad(
                    piece, ((0, 0), (0, t - rows), (0, 0), (0, t - cols))
                )
                block = piece.reshape(gy * t, gx * t)
                if canvas is None:
                    canvas = jnp.pad(block, ((0, nc * t), (0, nc * t)))
                else:
                    canvas = canvas.at[
                        cy * t:cy * t + gy * t, cx * t:cx * t + gx * t
                    ].add(block)
        planes.append(canvas[a:a + cfg.height, a:a + cfg.width])
    return jnp.stack(planes, axis=-1)


def composite_over_tiles(cfg: TiledRasterConfig, color_bins,
                         coverage_fn, background=None,
                         dither: bool = False, opacity=None):
    """Shared ordered-'over' per-tile scan (the compositing core of both
    the analytic and the textured-sprite alpha paths).

    `color_bins`: 4 planar (NT, K) PREMULTIPLIED channels, already
    masked by bin validity, from a `replicate_footprint=True` binning:
    every tile's bin holds ALL particles whose support touches the tile,
    so each tile composites its OWN pixels completely and the assembly
    takes tile-EXCLUSIVE crops (summing independently composited apron
    overlaps would ADD cross-tile overlapping particles instead of
    'over'-compositing them). `coverage_fn(j) -> (NT, win, win)`
    coverage in [0, 1] for slot j. `dither`: dithered-opacity discard
    (RasterizeParticleSystem.fx:158-175) with a 4x4 Bayer threshold per
    pixel instead of partial opacity. `opacity` (scalar, traced ok):
    global opacity multiplier on every fragment (the reference's
    opacity uniform). Returns the (H, W, 4) image (premultiplied rgb +
    accumulated alpha), composited over `background` if given.
    """
    cb = color_bins
    nt = cb[0].shape[0]
    k = cfg.bin_capacity
    win = cfg.window
    t, a = cfg.tile, cfg.apron
    gy, gx = cfg.grid

    bayer4 = jnp.asarray(
        [[0, 8, 2, 10], [12, 4, 14, 6], [3, 11, 1, 9], [15, 7, 13, 5]],
        jnp.float32,
    ) / 16.0
    # SCREEN-space Bayer indices (the reference thresholds by VPOS):
    # window pixel p of tile (ty, tx) sits at absolute ty*t + p - a, so
    # offset the 4-phase by (-a) mod 4 — tile origins are multiples of
    # t; a non-multiple-of-4 TILE would still shift per tile, so pin it.
    assert t % 4 == 0, "dither phase needs tile % 4 == 0"
    ys = (jnp.arange(win) - a) % 4
    xs = (jnp.arange(win) - a) % 4
    bayer = bayer4[ys[:, None], xs[None, :]]  # (win, win)

    src_a = jnp.maximum(cb[3], 1e-6)
    straight_rgb = jnp.stack(
        [cb[0] / src_a, cb[1] / src_a, cb[2] / src_a], axis=-1
    )  # (NT, K, 3)
    op_scale = 1.0 if opacity is None else opacity

    def over(img, j):
        a_eff = coverage_fn(j) * (cb[3][:, j][:, None, None] * op_scale)
        if dither:
            # Fragments become fully opaque where the effective alpha
            # beats the Bayer threshold, discarded elsewhere.
            a_eff = jnp.where(
                (a_eff > bayer[None]) & (a_eff > 0.0), 1.0, 0.0
            )
        rgb = img[..., :3] * (1.0 - a_eff[..., None]) + \
            straight_rgb[:, j][:, None, None, :] * a_eff[..., None]
        acc_a = img[..., 3] * (1.0 - a_eff) + a_eff
        return jnp.concatenate([rgb, acc_a[..., None]], axis=-1), None

    init = jnp.zeros((nt, win, win, 4), jnp.float32)
    tiles, _ = lax.scan(over, init, jnp.arange(k, dtype=jnp.int32))
    # Tile-EXCLUSIVE assembly: central [a, a+t) crops, plain reshapes.
    core = tiles[:, a:a + t, a:a + t, :].reshape(gy, gx, t, t, 4)
    img = core.transpose(0, 2, 1, 3, 4).reshape(gy * t, gx * t, 4)
    img = img[:cfg.height, :cfg.width]
    if background is not None:
        # img.rgb is premultiplied by the accumulated alpha; standard
        # premultiplied 'over' onto the background for BOTH rgb and
        # alpha (out_a = a + bg_a * (1 - a), not max).
        acc_a = jnp.clip(img[..., 3:4], 0.0, 1.0)
        img = jnp.concatenate(
            [img[..., :3] + background[..., :3] * (1.0 - acc_a),
             acc_a + background[..., 3:4] * (1.0 - acc_a)], axis=-1)
    return img


def rasterize_tiled_alpha(
    cfg: TiledRasterConfig,
    x, y, color, size, live,
    background=None,
    dither: bool = False,
    opacity=None,
):
    """Ordered 'over' compositing path.

    Composites bin slots in slot order per tile via lax.scan (the sort is
    stable, so order == state index order == reference draw order).
    `color` must be premultiplied; alpha channel = coverage opacity.

    O(K) sequential per tile — use for the (typically much smaller)
    alpha-blended systems; additive systems take rasterize_tiled.
    """
    assert not cfg.compact_payload, (
        "alpha compositing needs the alpha channel — compact payload "
        "repurposes it for size"
    )
    assert cfg.channels == 4, (
        "alpha compositing needs the alpha channel — channels=3 packs "
        "(b, size) into one operand and carries no alpha"
    )
    bins = bin_particles(cfg, x, y, color, size, live,
                         replicate_footprint=True)
    wy, wx = _coverage_factors(cfg, bins)
    valid = bins["valid"]
    cb = [c * valid for c in bins["color"]]  # planar premult channels

    def coverage(j):
        return wy[:, :, j][:, :, None] * wx[:, j, :][:, None, :]

    img = composite_over_tiles(cfg, cb, coverage, background, dither,
                               opacity=opacity)
    return img, dict(dropped=bins["dropped"])


# Convenience jitted aliases (see scan_shadows.scan_visibility_jit):
# one whole-graph, persistent-cache-eligible compile for eager callers.
rasterize_tiled_jit = jax.jit(
    rasterize_tiled, static_argnames=("cfg",))
rasterize_tiled_alpha_jit = jax.jit(
    rasterize_tiled_alpha, static_argnames=("cfg", "dither"))
