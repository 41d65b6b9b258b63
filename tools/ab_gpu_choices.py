"""A/B timings behind the per-platform choices, on the local accelerator.

Sections (each prints JSON lines; run one with --only NAME):
  maps    ColumnField map sampler (`columns._map_core`, XLA) at collision
          scale: 1M points against the voxel flagship's maps, sample and
          sample+grad.
  interp  Scattered voxel sampling on the voxel flagship's volume:
          8-tap gather (`sampling.sample`, + `estimate_normal` for the
          normal) vs the interpolation matrix (`sample_interp`,
          `sample_interp_grad`) at 1M (collision) and 8 x 540 x 960
          (refine candidates) points.
  vframe  Whole voxel flagship frame with interp dispatch "always" vs
          "never", for the default (carried) refine and the "exact"
          refine that samples the volume at every candidate.
  unroll  fast and parity 1080p frames at scan unroll 1, 4, 8 and 32.

Frame times: `frame_loop` compiled ahead of time (compile seconds
reported apart), primed once, then the median of REPEATS timed dispatches
of FRAMES frames, each ended by `jax.block_until_ready`.

Usage: python tools/ab_gpu_choices.py [--only maps|interp|vframe|unroll]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from illuminant.utils.compile_cache import enable_compile_cache  # noqa: E402

H, W, CAP = 1080, 1920, 1 << 20
# Scattered batch sizes: collision (1M particles) and the refine's
# candidates (8 lights at the fast preset's 540x960 shadow grid).
POINTS = (1 << 20, 8 * 540 * 960)
FRAMES = 10
REPEATS = 3


def emit(**row):
    print(json.dumps(row), flush=True)


def timed(fn, *args, repeats=10):
    """Median wall ms of fn(*args) after one warm-up call."""
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def _volume_and_points():
    import chip_smoke as cs

    volume, centers, sizes = cs._voxel_volume(H, W)
    pts = {n: cs._scattered_points(n, W, H, centers, sizes)
           for n in POINTS}
    return volume, pts


def section_maps():
    from illuminant.sdf.columns import (
        build_column_maps, sample_columns, sample_columns_grad)

    volume, pts = _volume_and_points()
    cols = build_column_maps(volume)
    p = pts[POINTS[0]]
    emit(section="maps", maps_c=list(cols.maps_c.shape), points=p.shape[0],
         sample_ms=timed(jax.jit(sample_columns), cols, p),
         grad_ms=timed(jax.jit(sample_columns_grad), cols, p))


def section_interp():
    from illuminant.sdf import sampling

    volume, pts = _volume_and_points()

    def gather_grad(v, p):
        return sampling.sample(v, p), sampling.estimate_normal(v, p)

    for n, p in pts.items():
        emit(section="interp", points=n,
             gather_ms=timed(jax.jit(sampling.sample), volume, p),
             interp_ms=timed(jax.jit(sampling.sample_interp), volume, p),
             gather_normal_ms=timed(jax.jit(gather_grad), volume, p),
             interp_grad_ms=timed(jax.jit(sampling.sample_interp_grad),
                                  volume, p))


def time_frame(**kwargs):
    """Compile seconds and median steady ms/frame of one flagship build."""
    from illuminant.scenes import build_flagship

    import chip_smoke as cs

    scene = build_flagship(height=H, width=W, capacity=CAP, **kwargs)
    state, avg, key, *rest = cs._frame_args(scene)
    t0 = time.perf_counter()
    compiled = scene.frame_loop.lower(
        state, avg, key, *rest, jnp.asarray(0, jnp.int32),
        n_frames=FRAMES).compile()
    compile_s = time.perf_counter() - t0
    img, state, avg, drops = jax.block_until_ready(
        compiled(state, avg, key, *rest, jnp.asarray(0, jnp.int32)))
    ts = []
    for r in range(REPEATS):
        t0 = time.perf_counter()
        img, state, avg, drops = jax.block_until_ready(compiled(
            state, avg, key, *rest,
            jnp.asarray((r + 1) * FRAMES, jnp.int32)))
        ts.append((time.perf_counter() - t0) * 1e3 / FRAMES)
    return {"compile_s": round(compile_s, 2),
            "ms_per_frame": round(float(np.median(ts)), 3),
            "ms_per_frame_all": [round(t, 3) for t in ts]}


def section_vframe():
    from illuminant.core.config import QualitySettings
    from illuminant.sdf.analytic import interp_dispatch

    for refine in ("carried", "exact"):
        for mode in ("always", "never"):
            with interp_dispatch(mode):
                row = time_frame(
                    preset="fast", field="voxel",
                    quality=QualitySettings(scan_refine_mode=refine))
            emit(section="vframe", refine=refine, interp=mode, **row)


def section_unroll():
    for preset in ("fast", "parity"):
        for unroll in (1, 4, 8, 32):
            os.environ["ILLUM_SCAN_UNROLL"] = str(unroll)
            try:
                row = time_frame(preset=preset)
            finally:
                del os.environ["ILLUM_SCAN_UNROLL"]
            emit(section="unroll", preset=preset, unroll=unroll, **row)


SECTIONS = {"maps": section_maps, "interp": section_interp,
            "vframe": section_vframe, "unroll": section_unroll}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", choices=sorted(SECTIONS))
    args = parser.parse_args()
    enable_compile_cache()
    dev = jax.devices()[0]
    import chip_smoke as cs

    emit(section="device", platform=dev.platform, kind=dev.device_kind,
         count=len(jax.devices()),
         nvidia_smi=cs.nvidia_smi() if dev.platform == "gpu" else None)
    for name, fn in SECTIONS.items():
        if args.only in (None, name):
            fn()


if __name__ == "__main__":
    main()
