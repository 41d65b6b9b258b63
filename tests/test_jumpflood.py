"""Jump-flood SDF vs brute-force distance oracle."""

import numpy as np
import jax.numpy as jnp

from illuminant.utils.jumpflood import jump_flood_sdf


def _oracle(mask):
    h, w = mask.shape
    inside = np.argwhere(mask)
    outside = np.argwhere(~mask)
    out = np.zeros((h, w), np.float64)
    for y in range(h):
        for x in range(w):
            if mask[y, x]:
                out[y, x] = -np.sqrt(
                    ((outside - [y, x]) ** 2).sum(1)).min()
            else:
                out[y, x] = np.sqrt(
                    ((inside - [y, x]) ** 2).sum(1)).min()
    return out


def test_jump_flood_matches_bruteforce():
    rng = np.random.default_rng(0)
    mask = np.zeros((48, 64), bool)
    mask[10:20, 12:30] = True
    mask[30:40, 40:56] = True
    sdf = np.asarray(jump_flood_sdf(jnp.asarray(mask)))
    oracle = _oracle(mask)
    # JFA is exact to ~1px.
    assert np.abs(sdf - oracle).max() <= 1.5, np.abs(sdf - oracle).max()
    assert (sdf[14, 20] < 0) and (sdf[0, 0] > 10)


def test_jump_flood_feeds_height_from_distance():
    from illuminant.utils.mapgen import height_from_distance

    mask = np.zeros((32, 32), bool)
    mask[8:24, 8:24] = True
    sdf = jump_flood_sdf(jnp.asarray(mask))
    h = np.asarray(height_from_distance(sdf, 0.0, 8.0, 0.0, 1.0))
    assert h[16, 16, 0] == 1.0  # deep inside -> max height
    # Corner is ~11.3 px from the box, beyond max_distance -> discarded.
    assert h[0, 0, 0] == 0.0 and h[0, 0, 3] == 0.0
