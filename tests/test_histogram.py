"""Luminance histogram vs a numpy oracle of Histogram.cs semantics."""

import numpy as np

from illuminant.utils import histogram as hg


def oracle_boundaries(max_value, power, n):
    out = []
    max_log = np.log(1 + max_value) / np.log(power)
    for i in range(n):
        out.append(power ** (max_log / n * (i + 1)) - 1)
    return np.asarray(out, np.float32)


def oracle_bucket(value, bounds):
    if value < bounds[0]:
        return 0
    if value >= bounds[-2]:
        return len(bounds) - 1
    for i, b in enumerate(bounds):
        if value < b:
            return i
    return len(bounds) - 1


def test_boundaries_match_oracle():
    got = hg.bucket_boundaries(64.0, 2.0, 64)
    want = oracle_boundaries(64.0, 2.0, 64)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_counts_match_oracle():
    rng = np.random.default_rng(0)
    lum = rng.uniform(0, 60, size=(32, 32)).astype(np.float32)
    # Build a lightmap whose luminance equals lum (pure green / 0.587).
    lightmap = np.zeros((32, 32, 4), np.float32)
    lightmap[..., 1] = lum / 0.587
    bounds = hg.bucket_boundaries(64.0, 2.0, 64)
    result = hg.compute_histogram(lightmap, bounds)
    counts = np.asarray(result.counts)

    want = np.zeros(64, np.int64)
    for v in lum.reshape(-1):
        want[oracle_bucket(v, bounds)] += 1
    # Float noise in the luminance reconstruction can shift values sitting
    # exactly on a boundary; allow a tiny count mismatch.
    assert np.abs(counts - want).sum() <= 4
    assert int(result.sample_count) == 32 * 32
    np.testing.assert_allclose(float(result.mean), lum.mean(), rtol=1e-3)
    np.testing.assert_allclose(float(result.max), lum.max(), rtol=1e-3)


def test_percentile():
    lum = np.linspace(0.0, 50.0, 10000).astype(np.float32)
    lightmap = np.zeros((100, 100, 4), np.float32)
    lightmap[..., 1] = (lum / 0.587).reshape(100, 100)
    bounds = hg.bucket_boundaries(64.0, 2.0, 64)
    result = hg.compute_histogram(lightmap, bounds)
    p50 = float(hg.percentile(result, 50.0))
    p95 = float(hg.percentile(result, 95.0))
    assert abs(p50 - 25.0) < 2.0, p50
    assert abs(p95 - 47.5) < 2.5, p95


def test_ignore_zeroes():
    lightmap = np.zeros((8, 8, 4), np.float32)
    lightmap[0, 0, 1] = 10.0 / 0.587
    bounds = hg.bucket_boundaries(64.0, 2.0, 64)
    r = hg.compute_histogram(lightmap, bounds, ignore_zeroes=True)
    assert int(r.sample_count) == 1
    np.testing.assert_allclose(float(r.mean), 10.0, rtol=1e-3)


def test_performance_stats():
    import time as _time

    from illuminant.utils.perf import PerformanceStats

    stats = PerformanceStats(samples=8)
    for _ in range(3):
        stats.begin_frame()
        stats.begin("update")
        _time.sleep(0.002)
        stats.end("update")
        stats.end_frame()
    assert stats.frame_ms >= 2.0
    assert stats.mean_ms("update") >= 2.0
    assert "update" in stats.report()
    assert stats.fps > 0


def test_normals_from_lightmaps():
    from illuminant.utils.mapgen import normals_from_lightmaps

    h = w = 16
    # Lit only from the right -> normal leans +x.
    left = np.full((h, w), 0.1, np.float32)
    right = np.full((h, w), 0.9, np.float32)
    above = np.full((h, w), 0.5, np.float32)
    below = np.full((h, w), 0.5, np.float32)
    out = np.asarray(normals_from_lightmaps(left, right, above, below))
    n = out[8, 8, :3] * 2.0 - 1.0
    assert n[0] > 0.4 and abs(n[1]) < 1e-3 and n[2] > 0.0
    np.testing.assert_allclose(np.linalg.norm(n), 1.0, atol=1e-3)
    # Dead pixels encode as zeros.
    dead = np.asarray(
        normals_from_lightmaps(*(np.zeros((h, w), np.float32),) * 4)
    )
    assert np.all(dead[..., :3] == 0.0)
