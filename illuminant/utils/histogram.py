"""On-device luminance histogram.

Port of /root/reference/Illuminant/Histogram.cs: 64 buckets with
log-spaced boundaries value_i = power^(log_power(1+max)/N * (i+1)) - 1
(:62-75), sample min/max/mean, and percentile queries (:~200+).

The reference computes this by GPU->CPU readback of a downsampled
luminance buffer on a worker thread (LightingRenderer.HDR.cs:21-55). Here
it is a fused on-device reduction over the lightmap — no readback, no ring
buffer, no thread pool (SURVEY.md §5.8) — returning a small pytree the
host can consume when it actually needs numbers.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..core.pytree import pytree_dataclass, static_field
from ..ops.tonemap import luminance


@pytree_dataclass
class HistogramResult:
    counts: jnp.ndarray  # (B,) int32
    boundaries: jnp.ndarray  # (B,) bucket max values
    min: jnp.ndarray  # ()
    max: jnp.ndarray  # ()
    mean: jnp.ndarray  # ()
    sample_count: jnp.ndarray  # () int32


def bucket_boundaries(max_value: float = 64.0, power: float = 2.0,
                      bucket_count: int = 64) -> np.ndarray:
    """Histogram.cs:62-75."""
    max_log = np.log(1.0 + max_value) / np.log(power)
    i = np.arange(1, bucket_count + 1, dtype=np.float64)
    return (np.power(power, max_log / bucket_count * i) - 1.0).astype(
        np.float32
    )


def bucket_index(lum, boundaries, power: float = 2.0,
                 max_value: float = 64.0):
    """(N,) luminance -> (N,) int32 bucket index (PickBucketForValue).

    Log-spaced `boundaries` (bucket_boundaries(max_value, power, B)) take
    the closed form idx = floor(log_power(1 + lum) * B / max_log), the
    exact inverse of the boundary formula. Any other sorted set
    (Histogram.cs PickBucketForValue accepts one) takes a searchsorted
    comparison; traced boundaries cannot be inspected and are trusted to
    match power/max_value."""
    b = boundaries.shape[0]
    analytic = True
    try:
        host_bounds = np.asarray(boundaries)
    except Exception:
        host_bounds = None
    if host_bounds is not None:
        expected = bucket_boundaries(max_value, power, b)
        analytic = host_bounds.shape == expected.shape and bool(
            np.allclose(host_bounds, expected, rtol=1e-4, atol=1e-5)
        )
    if analytic:
        max_log = float(np.log(1.0 + max_value) / np.log(power))
        scale = b / (max_log * float(np.log(power)))
        u = jnp.log1p(jnp.maximum(lum, 0.0)) * scale
        return jnp.clip(jnp.floor(u).astype(jnp.int32), 0, b - 1)
    # Bucket i takes values below boundaries[i] (the last bucket takes
    # everything past the second-last boundary).
    return jnp.clip(
        jnp.searchsorted(boundaries, lum, side="right").astype(jnp.int32),
        0, b - 1,
    )


def compute_histogram(lightmap, boundaries, ignore_zeroes: bool = False,
                      power: float = 2.0, max_value: float = 64.0):
    """(H, W, 4) HDR lightmap -> HistogramResult.

    Bucket pick matches Histogram.cs PickBucketForValue: first bucket takes
    values below its max, last bucket takes everything >= the second-last
    boundary. The boundaries are log-spaced (bucket_boundaries), so the
    bucket index is computed directly as
        idx = ceil(log_power(1 + lum) * B / log_power(1 + max)) - 1
    (the exact inverse of the boundary formula — no comparison matrix),
    then counted with ONE bf16 one-hot reduction (f32 sums). `power` /
    `max_value` must match the values used to build `boundaries`.
    """
    # f32 math over whatever input dtype (bf16 lightmaps read at half
    # bandwidth; the upcast fuses into the elementwise chain).
    lum = luminance(lightmap[..., :3]).reshape(-1).astype(jnp.float32)
    boundaries = jnp.asarray(boundaries)
    b = boundaries.shape[0]

    valid = jnp.ones_like(lum, dtype=bool)
    if ignore_zeroes:
        valid = lum > 0.0

    idx = bucket_index(lum, boundaries, power, max_value)
    one_hot = (
        idx[:, None] == jnp.arange(b, dtype=jnp.int32)[None, :]
    ) & valid[:, None]
    counts = jnp.sum(one_hot.astype(jnp.bfloat16), axis=0,
                     dtype=jnp.float32).astype(jnp.int32)

    n = jnp.sum(valid.astype(jnp.int32))
    big = jnp.float32(3.4e38)
    lum_or_big = jnp.where(valid, lum, big)
    lum_or_zero = jnp.where(valid, lum, 0.0)
    return HistogramResult(
        counts=counts,
        boundaries=boundaries,
        min=jnp.min(lum_or_big),
        max=jnp.max(jnp.where(valid, lum, -big)),
        mean=jnp.sum(lum_or_zero) / jnp.maximum(n, 1),
        sample_count=n,
    )


def percentile(result: HistogramResult, pct: float):
    """Approximate percentile from bucket counts (the reference keeps a
    sorted sample buffer for the exact value; bucket interpolation is the
    standard streaming equivalent)."""
    counts = result.counts.astype(jnp.float32)
    total = jnp.maximum(jnp.sum(counts), 1.0)
    cum = jnp.cumsum(counts)
    target = total * (pct / 100.0)
    reached = cum >= target
    b = result.counts.shape[0]
    idx = jnp.argmax(reached)  # first bucket reaching the target
    prev_cum = jnp.where(idx > 0, cum[jnp.maximum(idx - 1, 0)], 0.0)
    in_bucket = jnp.maximum(counts[idx], 1.0)
    frac = jnp.clip((target - prev_cum) / in_bucket, 0.0, 1.0)
    lo = jnp.where(idx > 0, result.boundaries[jnp.maximum(idx - 1, 0)], 0.0)
    hi = result.boundaries[idx]
    return lo + (hi - lo) * frac
