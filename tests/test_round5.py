"""Round-5 fixes.

1. `downsample2x_linear` (lighting/scan_shadows.py) replaces
   jax.image.resize for the exact-2x visibility downsample so the plane
   stays shard-local (PARALLEL.md round-5
   inventory: 0 all-gathers). It must be numerically IDENTICAL to the
   resize it replaces — edge-kernel renormalization included.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from illuminant.lighting.scan_shadows import downsample2x_linear


@pytest.mark.parametrize("shape,axis", [
    ((16, 24), 0),
    ((16, 24), 1),
    ((3, 32, 48), 1),
    ((3, 32, 48), 2),
    ((2, 4, 30, 128), 3),
])
def test_downsample2x_matches_resize(shape, axis):
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.normal(size=shape).astype(np.float32))
    got = downsample2x_linear(x, axis)
    want_shape = list(shape)
    want_shape[axis] = shape[axis] // 2
    want = jax.image.resize(x, tuple(want_shape), "linear")
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


def test_downsample2x_twice_is_resize_quarter():
    # The scan uses two chained calls for the (2H, 2W) -> (H, W) case —
    # pin the pair against the single-axis composition of resizes (the
    # separable resize applies axes independently, so chaining matches).
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=(64, 96)).astype(np.float32))
    got = downsample2x_linear(downsample2x_linear(x, 0), 1)
    want = jax.image.resize(
        jax.image.resize(x, (32, 96), "linear"), (32, 48), "linear")
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
