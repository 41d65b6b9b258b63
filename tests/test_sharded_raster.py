"""Bucketed sharded raster == unsharded raster; sort all-gather gone.

PARALLEL.md's own plan: the GSPMD raster all-gathers
the full lax.sort key set on every device; parallel/raster.py routes
particles to row-band owners with ONE all_to_all and sorts locally.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from illuminant.parallel import mesh as pmesh
from illuminant.parallel.raster import rasterize_tiled_sharded
from illuminant.raster.tiled import TiledRasterConfig, rasterize_tiled


def _mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    return pmesh.make_mesh(8)


def _particles(n, h, w, seed=0, cluster=None):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-8, w + 8, n).astype(np.float32)
    y = rng.uniform(-8, h + 8, n).astype(np.float32)
    if cluster is not None:
        cy, frac = cluster
        m = int(n * frac)
        y[:m] = rng.uniform(cy - 10, cy + 10, m)
        x[:m] = rng.uniform(0, w, m)
    color = rng.uniform(0.1, 1.0, (n, 4)).astype(np.float32)
    size = rng.uniform(1.0, 7.0, n).astype(np.float32)
    live = rng.uniform(0, 1, n) > 0.1
    return x, y, color, size, live


@pytest.mark.parametrize("compact", [False, True])
def test_sharded_matches_unsharded(compact):
    mesh = _mesh8()
    h, w, n = 256, 192, 1 << 12
    cfg = TiledRasterConfig(
        height=h, width=w, tile=32, bin_capacity=256, apron=4,
        rgba8_colors=True, channels=3, compact_payload=compact,
        overflow_tiles=0,
    )
    x, y, color, size, live = _particles(n, h, w)
    ref, ref_diag = jax.jit(
        lambda *a: rasterize_tiled(cfg, *a))(x, y, color, size, live)
    assert int(ref_diag["dropped"]) == 0

    xs = jax.device_put(jnp.asarray(x), pmesh.row_sharding(mesh))
    ys = jax.device_put(jnp.asarray(y), pmesh.row_sharding(mesh))
    cs = jax.device_put(jnp.asarray(color), pmesh.row_sharding(mesh))
    ss = jax.device_put(jnp.asarray(size), pmesh.row_sharding(mesh))
    ls = jax.device_put(jnp.asarray(live), pmesh.row_sharding(mesh))
    img, diag = jax.jit(
        lambda *a: rasterize_tiled_sharded(mesh, cfg, *a)
    )(xs, ys, cs, ss, ls)
    assert int(diag["dropped"]) == 0
    assert img.shape == ref.shape
    # Row-sharded output across the whole mesh.
    assert len(img.sharding.device_set) == 8, img.sharding
    np.testing.assert_allclose(np.asarray(img), np.asarray(ref),
                               atol=2e-2, rtol=1e-2)


def test_sharded_no_sort_allgather():
    """The optimized HLO must not all-gather the sort: collectives are
    one all-to-all (routing) + the output's assembly, nothing sized
    like the full key set."""
    mesh = _mesh8()
    h, w, n = 256, 192, 1 << 12
    cfg = TiledRasterConfig(height=h, width=w, tile=32, bin_capacity=256,
                            apron=4, rgba8_colors=True, channels=3,
                            overflow_tiles=0)
    x, y, color, size, live = _particles(n, h, w)
    args = [
        jax.device_put(jnp.asarray(a), pmesh.row_sharding(mesh))
        for a in (x, y, color, size, live)
    ]
    lowered = jax.jit(
        lambda *a: rasterize_tiled_sharded(mesh, cfg, *a)
    ).lower(*args)
    hlo = lowered.compile().as_text()
    assert "all-to-all" in hlo
    n_ag = hlo.count("all-gather(")
    assert n_ag == 0, f"{n_ag} all-gathers in sharded raster HLO"
    assert "sort" in hlo  # the local sorts are still there


def test_sharded_cluster_overflow_counted():
    """A band-concentrated cluster exceeding the send budget is COUNTED,
    never silent (the budget contract of every raster path)."""
    mesh = _mesh8()
    h, w, n = 256, 192, 1 << 12
    cfg = TiledRasterConfig(height=h, width=w, tile=32, bin_capacity=512,
                            apron=4, rgba8_colors=True, channels=3,
                            overflow_tiles=0)
    # 90% of particles in one 20-px row band.
    x, y, color, size, live = _particles(n, h, w, seed=3,
                                         cluster=(128.0, 0.9))
    args = [
        jax.device_put(jnp.asarray(a), pmesh.row_sharding(mesh))
        for a in (x, y, color, size, live)
    ]
    _, diag = jax.jit(
        lambda *a: rasterize_tiled_sharded(
            mesh, cfg, *a, send_budget_factor=1.0)
    )(*args)
    assert int(diag["dropped"]) > 0
    # With enough budget the same scene is exact.
    img2, diag2 = jax.jit(
        lambda *a: rasterize_tiled_sharded(
            mesh, cfg, *a, send_budget_factor=8.0)
    )(*args)
    assert int(diag2["dropped"]) == 0
    ref, _ = jax.jit(
        lambda *a: rasterize_tiled(cfg, *a))(x, y, color, size, live)
    np.testing.assert_allclose(np.asarray(img2), np.asarray(ref),
                               atol=2e-2, rtol=1e-2)


def test_adaptive_send_budget_at_scale():
    """The live occupancy diagnostic
    drives the budget. A band-clustered scene at scale either rasters
    exactly or the frame reports the deficit AND the factor that fixes
    it; feeding that factor back produces an exact raster."""
    from illuminant.parallel.raster import measure_send_budget_factor

    mesh = _mesh8()
    # Sized to exercise the contract, not throughput (512x384/64k
    # measured the same factors/deficits in 3x the wall-clock —
    # round-5 suite-time pass): the 95% band still needs factor ~7.3
    # > default 3.0, the cluster tiles still sit under bin_capacity.
    h, w, n = 256, 192, 1 << 14
    # bin_capacity sized for the cluster tiles so the test isolates
    # the SEND budget contract from bin overflow.
    cfg = TiledRasterConfig(height=h, width=w, tile=32,
                            bin_capacity=4096, apron=4,
                            rgba8_colors=True, channels=3,
                            overflow_tiles=0)
    x, y, color, size, live = _particles(n, h, w, seed=7,
                                         cluster=(150.0, 0.95))
    args = [
        jax.device_put(jnp.asarray(a), pmesh.row_sharding(mesh))
        for a in (x, y, color, size, live)
    ]
    _, diag = jax.jit(
        lambda *a: rasterize_tiled_sharded(mesh, cfg, *a)
    )(*args)
    assert int(diag["send_dropped"]) > 0  # deficit COUNTED, not silent
    assert float(diag["send_peak_fill"]) > 1.0
    # the surfaced factor covers the observed peak
    factor = measure_send_budget_factor(mesh, cfg, args[0], args[1],
                                        args[4])
    assert factor >= float(diag["suggested_send_budget_factor"])
    img2, diag2 = jax.jit(
        lambda *a: rasterize_tiled_sharded(
            mesh, cfg, *a, send_budget_factor=factor)
    )(*args)
    assert int(diag2["dropped"]) == 0
    assert float(diag2["send_peak_fill"]) <= 1.0
    ref, _ = jax.jit(
        lambda *a: rasterize_tiled(cfg, *a))(x, y, color, size, live)
    np.testing.assert_allclose(np.asarray(img2), np.asarray(ref),
                               atol=2e-2, rtol=1e-2)
