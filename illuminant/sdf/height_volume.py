"""Height volumes: polygonal 2.5D geometry.

Port of /root/reference/Illuminant/SDF/HeightVolume.cs (polygon + ZBase +
Height, top/front face meshes) and its two consumers:

  * G-buffer rasterization (LightingRenderer.GBuffer.cs:221-265 +
    GBuffer.fx HeightVolume/HeightVolumeFace): top faces write (normal up,
    z = top, relativeY = z * zToY); front faces extrude south-facing edges
    down to the ground with interpolated z. Here both are analytic
    per-pixel coverage tests (point-in-polygon + edge bands) instead of
    mesh rasterization — volumes are few and the pixel grid is the big
    axis (SURVEY.md §7.5).
  * the obstruction field: 2D polygon SDF (iq's formulation, Fracture
    SDF2D.fxh) extruded over the z range with the reference's finalEval
    composition and PolygonXyBias = 1.5 (DistanceField.fx:13, 46-72).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import jax.numpy as jnp

from ..core.pytree import pytree_dataclass

POLYGON_XY_BIAS = 1.5  # DistanceField.fx:13


@dataclasses.dataclass
class HeightVolume:
    """Host volume (HeightVolume.cs:15-23)."""

    polygon: Sequence[Tuple[float, float]]
    z_base: float = 0.0
    height: float = 32.0
    is_obstruction: bool = True
    top_face_enable_shadows: bool = True
    front_face_enable_shadows: bool = True
    is_dynamic: bool = False


@pytree_dataclass
class HeightVolumes:
    """SoA: polygons padded to E edges by repeating the last vertex
    (degenerate edges are no-ops in both the SDF and coverage tests)."""

    vertices: jnp.ndarray  # (P, E, 2) edge start points (closed loop)
    next_vertices: jnp.ndarray  # (P, E, 2) edge end points
    z_range: jnp.ndarray  # (P, 2) base, top
    top_shadows: jnp.ndarray  # (P,)
    front_shadows: jnp.ndarray  # (P,)
    active: jnp.ndarray  # (P,)

    @property
    def capacity(self):
        return self.vertices.shape[0]


def pack_height_volumes(volumes: List[HeightVolume],
                        max_edges: Optional[int] = None) -> HeightVolumes:
    n = len(volumes)
    cap = max(n, 1)
    e = max_edges or max((len(v.polygon) for v in volumes), default=3)
    verts = np.zeros((cap, e, 2), np.float32)
    nxt = np.zeros((cap, e, 2), np.float32)
    zr = np.zeros((cap, 2), np.float32)
    ts = np.ones((cap,), np.float32)
    fs = np.ones((cap,), np.float32)
    act = np.zeros((cap,), np.float32)
    for i, v in enumerate(volumes):
        poly = np.asarray(v.polygon, np.float32)
        m = len(poly)
        if m > e:
            raise ValueError(f"polygon has {m} > {e} edges")
        for j in range(e):
            a = poly[min(j, m - 1)]
            b = poly[(j + 1) % m] if j < m else poly[m - 1]
            verts[i, j] = a
            nxt[i, j] = b if j < m else a
        zr[i] = [v.z_base, v.z_base + v.height]
        ts[i] = 1.0 if v.top_face_enable_shadows else 0.0
        fs[i] = 1.0 if v.front_face_enable_shadows else 0.0
        act[i] = 1.0
    return HeightVolumes(
        vertices=jnp.asarray(verts),
        next_vertices=jnp.asarray(nxt),
        z_range=jnp.asarray(zr),
        top_shadows=jnp.asarray(ts),
        front_shadows=jnp.asarray(fs),
        active=jnp.asarray(act),
    )


def polygon_sdf_2d(point_xy, vertices, next_vertices):
    """iq signed polygon distance. point (..., 2); vertices (..., E, 2).

    Returns signed distance (negative inside). Degenerate (zero-length)
    pad edges contribute distance-to-point and no winding flips.
    """
    p = point_xy[..., None, :]
    a = vertices
    b = next_vertices
    e = b - a
    w = p - a
    ee = jnp.maximum(jnp.sum(e * e, axis=-1), 1e-12)
    t = jnp.clip(jnp.sum(w * e, axis=-1) / ee, 0.0, 1.0)
    proj = w - e * t[..., None]
    d2 = jnp.sum(proj * proj, axis=-1)
    dist2 = jnp.min(d2, axis=-1)

    # Winding: flip sign when all three or none of the crossing
    # conditions hold (iq sdPolygon).
    c1 = p[..., 1] >= a[..., 1]
    c2 = p[..., 1] < b[..., 1]
    c3 = e[..., 0] * w[..., 1] > e[..., 1] * w[..., 0]
    flip = (c1 & c2 & c3) | (~c1 & ~c2 & ~c3)
    s = 1.0 - 2.0 * jnp.mod(jnp.sum(flip.astype(jnp.int32), axis=-1), 2
                            ).astype(jnp.float32)
    return s * jnp.sqrt(jnp.maximum(dist2, 0.0))


def extruded_polygon_distance(position, volumes: HeightVolumes):
    """3D distance to all volumes (min), finalEval semantics
    (DistanceField.fx:46-72) with the xy bias. position (..., 3)."""
    sd2 = polygon_sdf_2d(
        position[..., None, :2], volumes.vertices, volumes.next_vertices
    )  # (..., P)
    distance_xy = sd2 + POLYGON_XY_BIAS
    z = position[..., None, 2]
    z0 = volumes.z_range[..., 0]
    z1 = volumes.z_range[..., 1]
    inside_z = (z >= z0) & (z <= z1)
    distance_z = jnp.where(
        inside_z,
        jnp.maximum(z - z1, z0 - z),
        jnp.where(z > z1, z - z1, z0 - z),
    )
    inside_xy = distance_xy <= 0.0
    d = jnp.where(
        inside_xy,
        jnp.where(distance_z <= 0.0, distance_xy + distance_z, distance_z),
        jnp.maximum(distance_xy, 0.0) + jnp.maximum(distance_z, 0.0),
    )
    d = jnp.where(volumes.active > 0.5, d, 1e9)
    return jnp.min(d, axis=-1)


