"""Multi-chip scaling via jax.sharding.

The reference is a single-GPU engine; its scale axes are chunked particle
state and per-frame field-update budgets (SURVEY.md §5.7). Here the
natural multi-device decomposition (SURVEY.md §5.8) is:

  * lighting: shard the PIXEL grid's row axis across the mesh — the resolve
    is embarrassingly parallel over pixels; every device holds the (small)
    SDF volume and light list replicated, so no collective is needed until
    the luminance histogram (a psum).
  * particles: shard the capacity axis — transforms/integration are
    element-wise over slots, so XLA keeps them local. Spawn writes a
    GLOBAL ring window at one cursor, which spans 1-2 shards per step;
    XLA routes the window write to the owning devices (verified
    numerically identical to the single-device step by
    tests/test_multichip.py; per-shard sub-rings would avoid that
    traffic entirely and are a possible future layout).

XLA inserts any needed collectives from the sharding annotations; there is
no hand-written communication here (on GPUs XLA hands psum/all_gather to
NCCL when the histogram/readback ops appear).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

PIXEL_AXIS = "px"


def make_mesh(n_devices: int | None = None) -> Mesh:
    devices = jax.devices()
    n = n_devices or len(devices)
    return Mesh(np.asarray(devices[:n]), (PIXEL_AXIS,))


def row_sharding(mesh: Mesh) -> NamedSharding:
    """Shard (H, ...) arrays by rows."""
    return NamedSharding(mesh, P(PIXEL_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_gbuffer(gbuffer, mesh: Mesh):
    """Place every (H, W[, C]) G-buffer plane row-sharded."""
    s = row_sharding(mesh)
    return jax.tree.map(lambda a: jax.device_put(a, s), gbuffer)


def shard_particles(state, mesh: Mesh):
    """Shard (N, 4) particle planes along capacity; scalars replicated."""
    s_rows = row_sharding(mesh)
    s_rep = replicated(mesh)

    def place(a):
        if getattr(a, "ndim", 0) >= 1 and a.shape[0] > 1:
            return jax.device_put(a, s_rows)
        return jax.device_put(a, s_rep)

    return jax.tree.map(place, state)


def replicate(tree, mesh: Mesh):
    s = replicated(mesh)
    return jax.tree.map(lambda a: jax.device_put(a, s), tree)
