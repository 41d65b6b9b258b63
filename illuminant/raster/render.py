"""ParticleSystem.Render — the user-facing particle draw entry.

Mirrors the reference's render path (ParticleSystem.cs:943-1039 material
pick + RasterizeParticleSystem.fx) over the array rasterizers:

  * ParticleAppearance (ParticleConfiguration.cs:42-109): texture +
    sprite-sheet layout, AnimationRate, Row/ColumnFromVelocity, Rounded,
    DitheredOpacity, RelativeSize, Bilinear (bilinear is implicit — the
    separable profiles are antialiased by construction).
  * No texture -> analytic kernels (quad, or rounded disc approximation).
  * Texture -> SVD sprite tables (raster/sprites.py), built once per
    appearance and cached on the object.
  * additive_blend False -> the ordered alpha compositor (with optional
    dithered opacity).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import jax.numpy as jnp

from ..particles.state import ParticleState
from . import sprites as sprites_mod
from .tiled import (
    KERNEL_GAUSS,
    KERNEL_QUAD,
    KERNEL_ROUND,
    TiledRasterConfig,
    rasterize_tiled,
    rasterize_tiled_alpha,
)


@dataclasses.dataclass
class ParticleAppearance:
    """ParticleAppearance (ParticleConfiguration.cs:42-109), array subset.

    texture None -> untextured quads (Rounded picks the disc profile).
    """

    texture: Optional[np.ndarray] = None  # (TH, TW[, C])
    columns: int = 1  # sprite sheet layout
    rows: int = 1
    animation_rate: Tuple[float, float] = (0.0, 0.0)
    rounded: bool = False
    glow: bool = False  # gaussian profile for untextured particles
    dithered_opacity: bool = False
    relative_size: bool = False  # size in texture-size units
    row_from_velocity: bool = False
    column_from_velocity: bool = False
    size_min: float = 2.0
    size_max: float = 12.0
    angle_bins: int = 8
    size_bins: int = 4
    rank: int = 4
    # Untextured kernel override: None = reference defaults (quad;
    # Rounded -> disc; glow -> gaussian); an explicit kernel string
    # (tiled.KERNEL_*) wins over the flags.
    kernel: Optional[str] = None
    # RoundingPowerFromLife (ParticleConfiguration.cs:82; evaluated at
    # the particle's life, RasterizeParticleSystem.fx:139): None keeps
    # the analytic KERNEL_ROUND disc (the power -> 1 hard-edge case); a
    # float or bezier (host models.parameter.Bezier or ops.bezier.
    # ClampedBezier) routes untextured Rounded particles through a
    # power-binned procedural disc table (sprites.build_power_disc_table)
    # so the EXACT radial computeCircularAlpha curve animates with life
    # — power quantized to `power_bins`, size to `size_bins` (the sprite
    # path's documented quantization contract).
    rounding_power_from_life: object = None
    power_bins: int = 8

    _table: object = dataclasses.field(default=None, repr=False)
    _ptable: object = dataclasses.field(default=None, repr=False)

    def sprite_table(self):
        if self.texture is None:
            return None
        # Cache keyed on the table-identity fields: mutating the
        # appearance (new texture, different layout/bins) rebuilds
        # instead of silently serving the stale SVD table.
        key = (id(self.texture), self.columns, self.rows,
               self.angle_bins, self.size_bins, self.rank,
               self.size_min, self.size_max)
        if self._table is None or self._table[0] != key:
            object.__setattr__(
                self, "_table",
                (key, sprites_mod.build_sprite_table(
                    self.texture,
                    frames_x=self.columns,
                    frames_y=self.rows,
                    angle_bins=max(self.angle_bins, 1),
                    size_bins=max(self.size_bins, 1),
                    rank=self.rank,
                    size_min=self.size_min,
                    size_max=self.size_max,
                )),
            )
        return self._table[1]

    def _power_curve(self):
        """Normalize rounding_power_from_life -> (ClampedBezier | None,
        (lo, hi) host power range)."""
        from ..ops.bezier import ClampedBezier, constant_bezier

        rp = self.rounding_power_from_life
        if rp is None:
            return None, (1.0, 1.0)
        if isinstance(rp, (int, float)):
            return constant_bezier([float(rp)]), (float(rp), float(rp))
        if not isinstance(rp, ClampedBezier):
            rp = rp.packed()  # host models.parameter.Bezier
        count = int(np.asarray(rp.range_and_count)[2])
        ctrl = np.asarray(rp.points)[:max(count, 1), 0]
        return rp, (float(ctrl.min()), float(ctrl.max()))

    def power_disc_table(self):
        """(SpriteTable, powers) for the RoundingPowerFromLife path,
        cached like sprite_table. `powers` is the host-side bin grid the
        per-particle frame index selects into."""
        _, (lo, hi) = self._power_curve()
        lo = min(max(lo, 0.01), 1.0)
        hi = min(max(hi, 0.01), 1.0)
        bins = 1 if hi - lo < 1e-6 else max(self.power_bins, 2)
        powers = tuple(
            float(p) for p in np.linspace(lo, hi, bins)
        )
        key = (powers, self.size_bins, self.rank, self.size_min,
               self.size_max)
        if self._ptable is None or self._ptable[0] != key:
            object.__setattr__(
                self, "_ptable",
                (key, sprites_mod.build_power_disc_table(
                    powers,
                    size_min=self.size_min,
                    size_max=self.size_max,
                    size_bins=max(self.size_bins, 1),
                    rank=self.rank,
                )),
            )
        return self._ptable[1], powers


def render_particles(
    state: ParticleState,
    config: TiledRasterConfig,
    appearance: Optional[ParticleAppearance] = None,
    additive_blend: bool = True,
    global_color=None,
    stipple_factor: float = 1.0,
    z_to_y: float = 0.0,
    size_scale: float = 1.0,
    background=None,
    z_formula=None,
    size_from_z: float = 0.0,
):
    """Render a particle system's live slots -> ((H, W, C) image, diag).

    The JAX ParticleSystem.Render: reads the state SoA (position /
    render_color / render_data), applies the appearance, and dispatches
    to the additive tiled splat, the ordered alpha compositor, or the
    sprite-table paths (additive or ordered alpha).

    `z_formula`: 4-vector (ParticleConfiguration.cs:282, fx:101-102):
    screen_z = dot(z_formula, (x, y, z, 1)). The reference feeds this to
    the depth test; with no depth buffer on the tiled path, it instead
    DEPTH-ORDERS the alpha compositing (back-to-front by screen_z) —
    additive blending is order-invariant, so it is a no-op there.
    `size_from_z`: size *= max(0, 1 + z * size_from_z) (fx:86,
    ParticleConfiguration.cs:287).
    """
    x = state.position[:, 0]
    y = state.position[:, 1] - state.position[:, 2] * z_to_y
    color = state.render_color
    if global_color is not None:
        color = color * jnp.asarray(global_color, jnp.float32)
    size = state.render_data[:, 0] * size_scale
    if not (isinstance(size_from_z, float) and size_from_z == 0.0):
        # Traced-value-safe guard (a bare `if size_from_z` would
        # concretize a traced factor / recompile per value).
        size = size * jnp.maximum(
            0.0, 1.0 + state.position[:, 2] * size_from_z
        )
    live = state.live_mask()

    app = appearance or ParticleAppearance()
    table = app.sprite_table()
    power_path = (table is None and app.rounded
                  and app.rounding_power_from_life is not None)
    powers = None
    if power_path:
        table, powers = app.power_disc_table()
        if config.compact_payload:
            # Sprite paths carry the variant id in a bf16 payload lane —
            # incompatible with the log-quantized compact payload.
            config = dataclasses.replace(config, compact_payload=False)

    if not (isinstance(stipple_factor, float) and stipple_factor >= 1.0):
        # StippleReject applies to every material (fx:101-110); same
        # traced-value guard + per-system phase offset as
        # rasterize_tiled's own path (systems interleave).
        from ..ops.coords import stipple_keep

        live = live & stipple_keep(state.capacity, stipple_factor,
                                   config.stipple_offset)

    order = None
    if z_formula is not None and not additive_blend:
        zf = jnp.asarray(z_formula, jnp.float32)
        screen_z = (
            state.position[:, 0] * zf[0]
            + state.position[:, 1] * zf[1]
            + state.position[:, 2] * zf[2]
            + zf[3]
        )
        # Back-to-front: the ordered compositor draws slot order, so
        # sort descending screen_z (stable — ties keep index order,
        # the reference's draw order).
        order = jnp.argsort(-jnp.where(live, screen_z, -jnp.inf),
                            stable=True)
        x, y, color, size, live = (
            x[order], y[order], color[order], size[order], live[order]
        )

    if table is not None:
        if app.relative_size and not power_path:
            # RelativeSize: size in texture-frame units. The tiled
            # footprint is square, so non-square frames use the LARGER
            # frame dimension (the reference sizes the quad per axis).
            tex = np.asarray(app.texture)
            fh = tex.shape[0] // max(app.rows, 1)
            fw = tex.shape[1] // max(app.columns, 1)
            size = size * max(max(fh, fw), 1)
        if power_path:
            # Frame = nearest power bin of the evaluated
            # RoundingPowerFromLife bezier (fx:139 evaluates at life);
            # discs are rotationally symmetric, so rotation is moot.
            from ..ops.bezier import evaluate_bezier

            cb, _rng = app._power_curve()
            p = evaluate_bezier(cb, state.position[:, 3])[..., 0]
            if len(powers) > 1:
                span = powers[-1] - powers[0]
                frame = jnp.round(
                    (jnp.clip(p, powers[0], powers[-1]) - powers[0])
                    / span * (len(powers) - 1)
                )
            else:
                frame = jnp.zeros_like(p)
            rotation = jnp.zeros_like(frame)
        else:
            rotation = state.render_data[:, 1]
            frame = sprites_mod.animation_frame(
                table,
                state.position[:, 3],
                state.velocity,
                animation_rate=app.animation_rate,
                row_from_velocity=app.row_from_velocity,
                column_from_velocity=app.column_from_velocity,
                frames_x=app.columns,
            ).astype(jnp.float32)
        if order is not None:
            rotation, frame = rotation[order], frame[order]
        if additive_blend:
            img, diag = sprites_mod.rasterize_sprites(
                config, table, x, y, color, size, live,
                rotation=rotation, frame=frame,
            )
            if background is not None:
                img = img + jnp.asarray(
                    background, img.dtype)[..., :img.shape[-1]]
            return img, diag
        return sprites_mod.rasterize_sprites_alpha(
            config, table, x, y, color, size, live,
            rotation=rotation, frame=frame,
            background=background, dither=app.dithered_opacity,
        )

    kernel = app.kernel or (
        KERNEL_GAUSS if app.glow
        else (KERNEL_ROUND if app.rounded else KERNEL_QUAD)
    )
    if config.kernel != kernel:
        config = dataclasses.replace(config, kernel=kernel)

    if additive_blend:
        # NOTE: dithered_opacity only applies to the ordered-alpha
        # paths — additive blending needs no opacity faking (the Bayer
        # discard exists to approximate transparency without sorting).
        img, diag = rasterize_tiled(config, x, y, color, size, live)
        if background is not None:
            # Additive onto the bound target (the reference's additive
            # blend state adds over whatever was rendered before).
            img = img + jnp.asarray(
                background, img.dtype)[..., :img.shape[-1]]
        return img, diag
    return rasterize_tiled_alpha(
        config, x, y, color, size, live,
        background=background,
        dither=app.dithered_opacity,
    )
