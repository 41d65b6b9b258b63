"""Sharded tiled rasterization: pre-bucket particles to row-band owners.

Under plain GSPMD the raster's global `lax.sort` over the
capacity-sharded key set is unshardable — XLA all-gathers the whole
key+payload set to every device (PARALLEL.md collective inventory: 2
all-gathers, the dominant multi-chip traffic at 1M particles). The
JAX-native layout (the fix PARALLEL.md names) instead routes each
particle to the device(s) whose pixel-row band its splat window
touches — ONE `lax.all_to_all` of (D, B, 8) f32 lanes — then sorts,
bins, and splats entirely locally per shard inside `shard_map`.
Per-device traffic drops from (D-1)/D x the full sorted set to the
send budget (~7/8 saved at D=8, uniform scenes).

Band layout: device d owns `band_tiles = ceil(gy / D)` consecutive
tile rows. A particle binned at tile row ty splats a window that
always touches tile rows {ty-1, ty, ty+1} (apron > 0 on both sides,
apron < tile), so it is sent to every DISTINCT band owner among those
three rows (1 owner in the interior, 2 at band seams; 3 only when
band_tiles == 1). Each device rasterizes its received set on a local
grid with ONE ghost tile row above and below, then crops the ghost
rows: every global output row gets each covering particle's
contribution exactly once, and nothing crosses devices after the
single all_to_all.

Budget semantics match the framework's raster contract everywhere
else (bin_capacity, tiled_lights): fixed per-(device, owner) slot
budget B = ceil(n_local * send_budget_factor / D), overflow COUNTED in
the returned diagnostics, never silent. Uniform scenes need factor ~1;
the default 3.0 absorbs typical clustering; a fully clustered scene
(every particle in one band) needs factor >= D for zero drops — at
that point row-sharding the raster is the wrong mesh and the
diagnostic says so.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..raster.tiled import TiledRasterConfig, rasterize_tiled
from .mesh import PIXEL_AXIS


def _band_layout(cfg: TiledRasterConfig, n_devices: int):
    gy, _gx = cfg.grid
    band_tiles = -(-gy // n_devices)
    band_h = band_tiles * cfg.tile
    return band_tiles, band_h


def rasterize_tiled_sharded(
    mesh: Mesh,
    cfg: TiledRasterConfig,
    x, y, color, size, live,
    stipple_factor: float = 1.0,
    send_budget_factor: float = 3.0,
):
    """Additive tiled rasterization over a row-banded device mesh.

    Drop-in for raster.tiled.rasterize_tiled under a
    parallel/mesh.py row mesh: x/y/color/size/live capacity-sharded
    (N % D == 0), output (H, W, C) row-sharded. Returns
    (image, dict(dropped=bin drops + send-budget drops, both counted
    across the mesh)).
    """
    d = mesh.devices.size
    if d == 1:
        return rasterize_tiled(cfg, x, y, color, size, live,
                               stipple_factor=stipple_factor)

    if not (isinstance(stipple_factor, float) and stipple_factor >= 1.0):
        # Stipple keys off the GLOBAL slot index (ops/coords.stipple_keep)
        # — apply before shard_map where indices are still global.
        from ..ops.coords import stipple_keep

        live = live & stipple_keep(x.shape[0], stipple_factor,
                                   cfg.stipple_offset)

    n = x.shape[0]
    assert n % d == 0, f"capacity {n} not divisible by mesh size {d}"
    n_loc = n // d
    gy, _gx = cfg.grid
    band_tiles, band_h = _band_layout(cfg, d)
    # Local grid: owned band + 1 ghost tile row above and below. The
    # routing rule (ty-1, ty, ty+1) keeps every received center tile
    # inside it.
    local_cfg = dataclasses.replace(
        cfg, height=(band_tiles + 2) * cfg.tile)
    # Spread estimate: particles land only on owners that own REAL tile
    # rows — when gy < D (small frames, dryruns) that is far fewer than
    # D and each used owner takes a 1/owners_used share, not 1/D.
    owners_used = max(-(-gy // band_tiles), 1)
    budget = max(
        int(np.ceil(n_loc * send_budget_factor / owners_used)), 64)
    budget = min(budget, 3 * n_loc)

    spec_n = P(PIXEL_AXIS)
    spec_nc = P(PIXEL_AXIS, None)
    spec_img = P(PIXEL_AXIS, None, None)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(spec_n, spec_n, spec_nc, spec_n, spec_n),
        out_specs=(spec_img, P(), P(), P()),
        check_vma=False,
    )
    def _body(xl, yl, cl, sl, ll):
        # --- route: owners of the 3 tile rows the window touches ---
        onscreen = (
            (xl > -(cfg.apron + 1.0)) & (xl < cfg.width + cfg.apron + 1.0)
            & (yl > -(cfg.apron + 1.0)) & (yl < cfg.height + cfg.apron + 1.0)
        )
        ok = ll & onscreen
        ty = jnp.clip((yl / cfg.tile).astype(jnp.int32), 0, gy - 1)
        o_mid = ty // band_tiles
        o_up = jnp.maximum(ty - 1, 0) // band_tiles
        o_dn = jnp.minimum(ty + 1, gy - 1) // band_tiles
        sent = jnp.int32(d)  # sort-to-end sentinel for masked sends
        cands = jnp.stack([
            jnp.where(ok, o_mid, sent),
            jnp.where(ok & (o_up != o_mid), o_up, sent),
            jnp.where(ok & (o_dn != o_mid) & (o_dn != o_up), o_dn, sent),
        ])  # (3, n_loc)
        src = jnp.broadcast_to(
            jnp.arange(n_loc, dtype=jnp.int32)[None, :], (3, n_loc))
        owner_keys, src_sorted = lax.sort(
            (cands.reshape(-1), src.reshape(-1)), num_keys=1,
            is_stable=False)

        starts = jnp.searchsorted(
            owner_keys, jnp.arange(d + 1, dtype=jnp.int32)
        ).astype(jnp.int32)
        counts = starts[1:] - starts[:-1]  # (D,)
        send_drops = jnp.sum(jnp.maximum(counts - budget, 0))

        # --- pack send buffer: (D, B) slots, 8 f32 lanes ---
        j = jnp.arange(budget, dtype=jnp.int32)[None, :]
        slot = starts[:-1][:, None] + j  # (D, B)
        valid = (j < counts[:, None]).astype(jnp.float32)
        src_idx = src_sorted[jnp.clip(slot, 0, 3 * n_loc - 1)]  # (D, B)
        lanes = jnp.stack(
            [xl[src_idx], yl[src_idx], sl[src_idx], valid,
             cl[src_idx, 0], cl[src_idx, 1], cl[src_idx, 2],
             cl[src_idx, 3]],
            axis=-1,
        )  # (D, B, 8)
        lanes = lanes * valid[..., None]

        # --- the one collective ---
        recv = lax.all_to_all(lanes, PIXEL_AXIS, split_axis=0,
                              concat_axis=0, tiled=True)
        recv = recv.reshape(d * budget, 8)

        # --- local raster on the ghost-extended band grid ---
        d_idx = lax.axis_index(PIXEL_AXIS)
        row0 = (d_idx * band_tiles - 1) * cfg.tile  # ghost row origin
        xr = recv[:, 0]
        yr = recv[:, 1] - row0.astype(jnp.float32)
        sr = recv[:, 2]
        lr = recv[:, 3] > 0.5
        cr = recv[:, 4:8]
        img_ext, diag = rasterize_tiled(local_cfg, xr, yr, cr, sr, lr)
        img_band = img_ext[cfg.tile:cfg.tile + band_h]

        dropped = lax.psum(diag["dropped"] + send_drops, PIXEL_AXIS)
        send_dropped = lax.psum(send_drops, PIXEL_AXIS)
        # Peak (src device, owner) routing demand — the live occupancy
        # signal the budget is tuned against: a
        # frame with send_peak_fill <= 1 rastered exactly; above 1 the
        # deficit is counted in send_dropped and the factor that WOULD
        # have routed it is surfaced for the next build.
        peak = lax.pmax(jnp.max(counts), PIXEL_AXIS)
        return img_band, dropped, send_dropped, peak

    img_full, dropped, send_dropped, peak = _body(x, y, color, size, live)
    # D * band_h >= gy * tile >= height: crop the band padding.
    return img_full[:cfg.height], dict(
        dropped=dropped,
        send_dropped=send_dropped,
        send_budget=jnp.asarray(budget, jnp.int32),
        send_peak_fill=peak.astype(jnp.float32) / float(budget),
        # factor that makes budget == peak this frame (+1 slot of slack
        # for ceil rounding); feed back into send_budget_factor.
        suggested_send_budget_factor=(
            (peak.astype(jnp.float32) + 1.0)
            * float(owners_used) / float(n_loc)),
    )


def measure_send_budget_factor(mesh, cfg, x, y, live,
                               slack: float = 1.25) -> float:
    """Concrete adaptive tuning: route one representative frame's
    particles (no raster) and return the send_budget_factor that covers
    its peak band demand with `slack` headroom. Callers bake the result
    into the jitted frame — the array equivalent of the reference growing
    its buffers between frames (static shapes can't grow mid-jit, so
    adaptation happens at build/rebuild time)."""
    _img, diag = rasterize_tiled_sharded(
        mesh, cfg, x, y,
        jnp.zeros((x.shape[0], 4), jnp.float32),
        jnp.ones((x.shape[0],), jnp.float32), live,
        send_budget_factor=float(mesh.devices.size),  # lossless probe
    )
    return float(diag["suggested_send_budget_factor"]) * slack
