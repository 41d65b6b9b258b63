"""The 3D signed distance field volume.

Reference: /root/reference/Illuminant/SDF/DistanceField.cs (virtual WxHxD
volume at a 0.05-1 resolution scale, slices packed 3-per-RGBA-texel into a 2D
atlas, Rgba64 storage, incremental per-slice generation budget) and
LightingRenderer.DistanceField.cs (GPU rasterization of obstruction SDFs with
MAX blend over encoded distances).

Array design: the atlas/packing was a GPU texture-format workaround — here the
field is simply a dense (S, H, W) float32 array of *raw* signed distances
(slice-major so a Z-slab is contiguous), generated by evaluating the
obstruction SDF scene directly on the voxel grid (ops/sdf_primitives) and
min-reduced over obstructions. Incremental regeneration updates a budgeted
number of slices per frame via lax.dynamic_update_slice — same semantics as
`MaximumFieldUpdatesPerFrame` (LightingRenderer.Configuration.cs:87-91) with
slice validity tracked host-side. The static/dynamic split of
DynamicDistanceField (DistanceField.cs:248-321) becomes two arrays combined
with jnp.minimum.

Coordinate convention (matches the reference sampler,
DistanceFieldCommon.fxh:303-353): slice s holds distances at world
z = s * virtual_depth / slice_count + z_offset (LightingRenderer.
DistanceField.cs:32-34); texel (y, x) holds distances at world
xy = ((x + 0.5) / scale_x, (y + 0.5) / scale_y) — the +0.5 matches GPU
bilinear texel centers so `sample` (sampling.py) is the exact inverse.

The 16-bit encoding `encoded = 192/255 - d / max_encoded_distance`
(DistanceFieldCommon.fxh:8,264-270) is kept only for save/load compatibility
with reference field dumps and for golden tests.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..core.pytree import pytree_dataclass, static_field
from ..ops import sdf_primitives

DISTANCE_ZERO = 192.0 / 255.0  # DistanceFieldCommon.fxh:8


@pytree_dataclass
class SdfObstructions:
    """SoA obstruction set (LightObstruction.cs:10-36), padded to a static N.

    types: (N,) int32 (sdf_primitives.TYPE_*; TYPE_NONE = inactive pad)
    centers, sizes: (N, 3) f32; rotations: (N, 4) f32 quaternion (x,y,z,w).
    """

    types: jnp.ndarray
    centers: jnp.ndarray
    sizes: jnp.ndarray
    rotations: jnp.ndarray

    @staticmethod
    def empty(capacity: int) -> "SdfObstructions":
        n = capacity
        rot = np.zeros((n, 4), np.float32)
        rot[:, 3] = 1.0
        return SdfObstructions(
            types=jnp.zeros((n,), jnp.int32),
            centers=jnp.zeros((n, 3), jnp.float32),
            sizes=jnp.ones((n, 3), jnp.float32),
            rotations=jnp.asarray(rot),
        )

    @staticmethod
    def from_lists(types, centers, sizes, rotations=None, capacity=None):
        n = len(types)
        cap = capacity or max(n, 1)
        if cap < n:
            raise ValueError(
                f"capacity {cap} < {n} obstructions")
        out = SdfObstructions.empty(cap)
        if n == 0:
            return out
        t = np.zeros((cap,), np.int32)
        c = np.zeros((cap, 3), np.float32)
        s = np.ones((cap, 3), np.float32)
        r = np.zeros((cap, 4), np.float32)
        r[:, 3] = 1.0
        t[:n] = np.asarray(types, np.int32)
        c[:n] = np.asarray(centers, np.float32)
        s[:n] = np.asarray(sizes, np.float32)
        if rotations is not None:
            r[:n] = np.asarray(rotations, np.float32)
        return SdfObstructions(
            types=jnp.asarray(t),
            centers=jnp.asarray(c),
            sizes=jnp.asarray(s),
            rotations=jnp.asarray(r),
        )


@pytree_dataclass
class SdfVolumeConfig:
    """Static field geometry (DistanceField.cs:38-109 minus atlas packing)."""

    virtual_width: int = static_field(default=256)
    virtual_height: int = static_field(default=256)
    virtual_depth: int = static_field(default=128)
    slice_count: int = static_field(default=16)
    resolution_scale: float = static_field(default=0.25)
    max_encoded_distance: float = static_field(default=128.0)
    z_offset: float = static_field(default=0.0)

    @property
    def slice_width(self) -> int:
        return max(1, int(round(self.virtual_width * self.resolution_scale)))

    @property
    def slice_height(self) -> int:
        return max(1, int(round(self.virtual_height * self.resolution_scale)))

    @property
    def shape(self):
        return (self.slice_count, self.slice_height, self.slice_width)

    @property
    def scale_x(self) -> float:
        """Texels per world unit in x (1/InvScaleFactorX, Uniforms.cs:106)."""
        return self.slice_width / self.virtual_width

    @property
    def scale_y(self) -> float:
        return self.slice_height / self.virtual_height

    @property
    def slice_z_size(self) -> float:
        """World-z distance between slices (Uniforms.cs:94)."""
        return self.virtual_depth / self.slice_count


@pytree_dataclass
class SdfVolume:
    """The field data + dynamic sampling parameters.

    data: (S, H, W) f32 raw signed distances (world units).
    max_valid_z: scalar f32 — world-z of the last generated slice
      (TextureSliceCount.z semantics, Uniforms.cs:95-99); sampling clamps to
      it so partially generated fields behave like the reference.
    """

    data: jnp.ndarray
    max_valid_z: jnp.ndarray
    config: SdfVolumeConfig = static_field(default_factory=SdfVolumeConfig)

    @staticmethod
    def empty(config: SdfVolumeConfig) -> "SdfVolume":
        return SdfVolume(
            data=jnp.full(config.shape, config.max_encoded_distance,
                          dtype=jnp.float32),
            max_valid_z=jnp.asarray(0.0, jnp.float32),
            config=config,
        )


def _voxel_world_coords(config: SdfVolumeConfig, slice_start: int,
                        slice_stop: int):
    """World-space sample positions for slices [start, stop)."""
    xs = (jnp.arange(config.slice_width, dtype=jnp.float32) + 0.5) / config.scale_x
    ys = (jnp.arange(config.slice_height, dtype=jnp.float32) + 0.5) / config.scale_y
    zs = (
        jnp.arange(slice_start, slice_stop, dtype=jnp.float32)
        * config.slice_z_size
        + config.z_offset
    )
    z, y, x = jnp.meshgrid(zs, ys, xs, indexing="ij")
    return jnp.stack([x, y, z], axis=-1)  # (s, H, W, 3)


def generate_slab(config: SdfVolumeConfig, obstructions: SdfObstructions,
                  slice_start: int, slice_count: int) -> jnp.ndarray:
    """Generate `slice_count` slices starting at `slice_start`.

    Equivalent of RenderDistanceFieldSliceTriplet + per-type instanced SDF
    draws (LightingRenderer.DistanceField.cs:80-183) collapsed into one dense
    evaluation: every voxel evaluates every obstruction, min-reduced.
    Distances are clamped to the range the encoded Rgba64 texture could
    actually represent: encode = (0.753 - d/(4m)) stored UNORM, so the
    representable band is [-(63/255)*m, (192/255)*m] (encode of 1 and 0
    respectively, DistanceFieldCommon.fxh:264-270) — a plain [-m, +m]
    clamp could never round-trip against reference field dumps for
    far-from-geometry voxels.
    """
    pos = _voxel_world_coords(config, slice_start, slice_start + slice_count)
    d = sdf_primitives.scene_distance(
        pos,
        obstructions.types,
        obstructions.centers,
        obstructions.sizes,
        obstructions.rotations,
    )
    m = config.max_encoded_distance
    return jnp.clip(d, -(63.0 / 255.0) * m, (192.0 / 255.0) * m)


def generate_volume(config: SdfVolumeConfig,
                    obstructions: SdfObstructions) -> SdfVolume:
    """Generate the full field in one shot (all slices valid)."""
    data = generate_slab(config, obstructions, 0, config.slice_count)
    return SdfVolume(
        data=data,
        max_valid_z=jnp.asarray(
            config.slice_count * config.slice_z_size, jnp.float32
        ),
        config=config,
    )


def update_slices(volume: SdfVolume, slice_start,
                  slab: jnp.ndarray) -> SdfVolume:
    """Write a regenerated slab into the volume at a dynamic slice index.

    The incremental-update path: host code tracks invalid slices (like
    DistanceField.InvalidSlices, DistanceField.cs:13-16) and calls this with
    a budget of slices per frame. The slab must fit: dynamic_update_slice
    CLAMPS an out-of-range start, which would silently write every slice
    one plane off — guard host-side when the start is static.
    """
    if isinstance(slice_start, int):
        if slice_start < 0 or (
                slice_start + slab.shape[0] > volume.data.shape[0]):
            raise ValueError(
                f"slab [{slice_start}, {slice_start + slab.shape[0]}) "
                f"out of range for {volume.data.shape[0]} slices")
    data = jax.lax.dynamic_update_slice(
        volume.data, slab, (jnp.asarray(slice_start, jnp.int32), 0, 0)
    )
    return volume.replace(data=data)


def _generate_slices_at(config: SdfVolumeConfig,
                        obstructions: SdfObstructions,
                        slice_index) -> jnp.ndarray:
    """One slice at a TRACED index — the budgeted-regen building block.

    `_voxel_world_coords` takes static bounds (jnp.arange needs them);
    this shifts a unit arange by the traced index instead.
    """
    xs = (jnp.arange(config.slice_width, dtype=jnp.float32) + 0.5) \
        / config.scale_x
    ys = (jnp.arange(config.slice_height, dtype=jnp.float32) + 0.5) \
        / config.scale_y
    z = slice_index.astype(jnp.float32) * config.slice_z_size \
        + config.z_offset
    y, x = jnp.meshgrid(ys, xs, indexing="ij")
    pos = jnp.stack(
        [x, y, jnp.broadcast_to(z, x.shape)], axis=-1)[None]  # (1, H, W, 3)
    d = sdf_primitives.scene_distance(
        pos, obstructions.types, obstructions.centers, obstructions.sizes,
        obstructions.rotations)
    m = config.max_encoded_distance
    return jnp.clip(d, -(63.0 / 255.0) * m, (192.0 / 255.0) * m)


def invalid_slices_for_bounds(config: SdfVolumeConfig,
                              obstructions: SdfObstructions,
                              band: float = 0.0) -> jnp.ndarray:
    """Device-side slice invalidation (DistanceField.InvalidSlices,
    DistanceField.cs:13-16; marked by obstruction bounds in
    LightingRenderer.DistanceField.cs:415-462).

    A slice is invalid when its world-z plane lies within any active
    obstruction's conservative radius (|size| covers every primitive
    under rotation) expanded by `band`. `band` chooses how far out a
    moved surface must stay *accurate* — pass the largest distance the
    frame actually consumes (cone radius / collision band), NOT
    max_encoded_distance: beyond the band the stale values are still
    conservative bounds from the unmoved set min-combined with the
    static field.

    Returns an (S,) bool mask; OR masks across frames host-free to
    accumulate pending invalidations.
    """
    zs = (jnp.arange(config.slice_count, dtype=jnp.float32)
          * config.slice_z_size + config.z_offset)
    active = obstructions.types != sdf_primitives.TYPE_NONE
    half = jnp.sqrt(jnp.sum(obstructions.sizes ** 2, axis=-1)) + band
    lo = obstructions.centers[:, 2] - half
    hi = obstructions.centers[:, 2] + half
    hit = ((zs[:, None] >= lo[None, :]) & (zs[:, None] <= hi[None, :])
           & active[None, :])
    return jnp.any(hit, axis=1)


def regenerate_invalid_budgeted(volume: SdfVolume,
                                obstructions: SdfObstructions,
                                invalid: jnp.ndarray,
                                budget: int):
    """MaximumFieldUpdatesPerFrame semantics
    (LightingRenderer.Configuration.cs:87-91, DistanceField slice queue
    LightingRenderer.DistanceField.cs:415-462): regenerate up to
    `budget` invalid slices this frame, lowest index first; the rest
    stay STALE until a later frame.

    Per-frame cost is budget * H * W * N_pad SDF evaluations — fixed by
    the budget, independent of how many slices the dynamic set dirtied.
    Returns (volume', invalid') where invalid' has the regenerated
    slices cleared; all traced, jit/scan-safe.
    """
    s_count = volume.config.slice_count
    lanes = jnp.arange(s_count)

    def one(carry, _):
        data, mask = carry
        idx = jnp.argmax(mask)  # first pending slice (0 if none)
        present = jnp.any(mask)
        slab = _generate_slices_at(volume.config, obstructions, idx)
        updated = jax.lax.dynamic_update_slice(
            data, slab, (idx.astype(jnp.int32), 0, 0))
        data = jnp.where(present, updated, data)
        mask = mask & (lanes != idx)
        return (data, mask), None

    (data, invalid), _ = jax.lax.scan(
        one, (volume.data, invalid), None, length=budget)
    return volume.replace(data=data), invalid


def combine_static_dynamic(static_volume: SdfVolume,
                           dynamic_volume: SdfVolume) -> SdfVolume:
    """DynamicDistanceField composition (DistanceField.cs:248-321): the
    closest surface of the static and dynamic obstruction sets."""
    return dynamic_volume.replace(
        data=jnp.minimum(static_volume.data, dynamic_volume.data),
        max_valid_z=jnp.minimum(
            static_volume.max_valid_z, dynamic_volume.max_valid_z
        ),
    )


# --- encode/decode + save/load (reference-format compatibility) ---------


def encode_distance(d, max_encoded_distance):
    """DistanceFieldCommon.fxh:264-266."""
    return DISTANCE_ZERO - (d / max_encoded_distance)


def decode_distance(e, max_encoded_distance):
    """DistanceFieldCommon.fxh:268-270."""
    return (DISTANCE_ZERO - e) * max_encoded_distance


def save(volume: SdfVolume, path: str) -> None:
    """Save as npz (raw f32 distances + geometry). The reference's Save
    writes raw Rgba64 texture bytes (DistanceField.cs:178-213); our canonical
    on-disk form is the unpacked array, with encode/decode available for
    interop tests."""
    c = volume.config
    np.savez_compressed(
        path,
        data=np.asarray(volume.data),
        max_valid_z=np.asarray(volume.max_valid_z),
        geometry=np.asarray(
            [
                c.virtual_width,
                c.virtual_height,
                c.virtual_depth,
                c.slice_count,
            ],
            # float64: the reference's VirtualDepth is a float
            # (DistanceField.cs) — int64 silently truncated fractional
            # depths and shifted every reloaded z sample.
            np.float64,
        ),
        params=np.asarray(
            [c.resolution_scale, c.max_encoded_distance, c.z_offset],
            np.float64,
        ),
    )


def load(path: str) -> SdfVolume:
    import os as _os

    # np.savez_compressed appends '.npz' when missing — mirror that here
    # so save(v, p); load(p) round-trips for extensionless paths.
    if not _os.path.exists(path) and _os.path.exists(path + ".npz"):
        path = path + ".npz"
    with np.load(path) as f:
        geo = f["geometry"]
        par = f["params"]
        depth = float(geo[2])
        config = SdfVolumeConfig(
            virtual_width=int(geo[0]),
            virtual_height=int(geo[1]),
            virtual_depth=int(depth) if depth == int(depth) else depth,
            slice_count=int(geo[3]),
            resolution_scale=float(par[0]),
            max_encoded_distance=float(par[1]),
            z_offset=float(par[2]),
        )
        data = f["data"]
        if tuple(data.shape) != config.shape:
            raise ValueError(
                f"field data shape {tuple(data.shape)} does not match "
                f"the geometry-derived {config.shape} — corrupt or "
                "mismatched file")
        return SdfVolume(
            data=jnp.asarray(data),
            max_valid_z=jnp.asarray(f["max_valid_z"]),
            config=config,
        )
