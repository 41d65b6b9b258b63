"""Benchmark harness.

Measures the FULL BASELINE.md config-5 workload on the local accelerator:
1080p 8-light SDF-shadowed light resolve with dynamic occluders, a
1M-particle step (bezier-animated spawner, gravity, SDF collision),
full-resolution tiled particle rasterization, HDR luminance histogram
auto-exposure, and Uncharted2 tonemap resolve to uint8 — one jitted frame.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
value = frames (steps) per second of the fused frame; vs_baseline is
against the 60 steps/s target (BASELINE.json north_star). The other four
flagship variants (parity, full_family, parity_full_family, voxel) ride
along as `<row>_fps` fields. Any failing row fails the run (non-zero
exit, no JSON line).

Usage: python bench.py [--small] [--frames N]
"""

from __future__ import annotations

import json
import sys
import time

import jax
import jax.numpy as jnp

from illuminant.utils.compile_cache import enable_compile_cache

# Frames per dispatch: amortizes the per-dispatch cost while keeping each
# execution short.
CHUNK = 25
# Upper bound on one row's measured wall-clock, in seconds.
MAX_WINDOW_S = 45.0

UNITS = {
    "parity": (
        "same frame at reference-parity quality: collision_substeps "
        "3, shadow_scale 1.0, march-equivalent refine (A/B: "
        "test_refine_quality), round kernel, full-precision payload"),
    "full_family": (
        "flagship + directional sun + line + shadowed volumetric + "
        "projector + 32 particle lights, one fused frame"),
    "parity_full_family": (
        "full light family at parity quality: every family at "
        "lightmap res, collision_substeps 3, shadow_scale 1.0, "
        "round kernel, full-precision payload"),
    "voxel": (
        "flagship rendered from a baked save/load SdfVolume static "
        "partition + per-frame dynamic partition regen (the shipped-"
        "scene field path, DistanceField.cs:18-22,178-213,248-321)"),
}


def main():
    small = "--small" in sys.argv
    frames = 400
    if "--frames" in sys.argv:
        frames = int(sys.argv[sys.argv.index("--frames") + 1])
    enable_compile_cache()
    from illuminant.scenes import FLAGSHIP_VARIANTS

    dev = jax.devices()[0]
    print(f"# device: {dev.platform} {dev.device_kind} "
          f"x{len(jax.devices())}", file=sys.stderr)
    height, width, capacity = ((270, 480, 1 << 16) if small
                               else (1080, 1920, 1 << 20))

    rows = {}
    for name, kwargs in FLAGSHIP_VARIANTS.items():
        n = frames if name == "fast" else max(frames // 2, 200)
        rows[name] = _bench_variant(height, width, capacity, n, **kwargs)
        print(f"# {name}: {rows[name]}", file=sys.stderr)

    fast = rows["fast"]
    result = {
        "metric": "1080p light-resolve Mpix/s; 1M-particle steps/sec",
        "value": fast["fps"],
        "unit": "fused frames/sec (full config-5: 8-light SDF resolve + "
                "dynamic occluders + 1M-particle step + tiled raster + "
                "HDR histogram tonemap)",
        "vs_baseline": round(fast["fps"] / 60.0, 4),
        "mpix_per_sec": fast["mpix_per_sec"],
        "resolution": f"{width}x{height}",
        "particle_capacity": capacity,
        "live_particles": fast["live_particles"],
        "raster_dropped_max": fast["raster_dropped_max"],
        "device": str(dev),
    }
    for name, unit in UNITS.items():
        result[f"{name}_fps"] = rows[name]["fps"]
        result[f"{name}_vs_baseline"] = round(rows[name]["fps"] / 60.0, 4)
        result[f"{name}_unit"] = unit
    result["parity_raster_dropped_max"] = rows["parity"][
        "raster_dropped_max"]
    print(json.dumps(result))


def _bench_variant(height, width, capacity, frames, **kwargs):
    from illuminant.scenes import build_flagship

    scene = build_flagship(height=height, width=width, capacity=capacity,
                           **kwargs)
    state = scene.system.state
    key = jax.random.key(0)
    env_u = scene.environment.uniforms()
    avg_lum = jnp.asarray(0.5, jnp.float32)
    spawn_count = jnp.asarray(scene.spawner.spawn_max, jnp.int32)

    def run(state, avg_lum, i0):
        return scene.frame_loop(
            state, avg_lum, key, scene.volume, scene.gbuffer,
            scene.sphere_lights, env_u, spawn_count,
            jnp.asarray(i0, jnp.int32), CHUNK,
        )

    # Warm up: compile and prime the particle population, then time one
    # chunk to size the measured window.
    img, state, avg_lum, drops = jax.block_until_ready(
        run(state, avg_lum, 0))
    t0 = time.perf_counter()
    img, state, avg_lum, drops = jax.block_until_ready(
        run(state, avg_lum, CHUNK))
    per_chunk = time.perf_counter() - t0
    n_chunks = max(1, min(frames // CHUNK, int(MAX_WINDOW_S / per_chunk)))
    done = 2 * CHUNK
    t0 = time.perf_counter()
    for c in range(n_chunks):
        img, state, avg_lum, drops = run(state, avg_lum,
                                         done + c * CHUNK)
    jax.block_until_ready((img, state))
    dt = time.perf_counter() - t0

    steps_per_sec = n_chunks * CHUNK / dt
    return {
        "fps": round(steps_per_sec, 3),
        "mpix_per_sec": round(steps_per_sec * height * width / 1e6, 1),
        "live_particles": int(jnp.sum(state.position[:, 3] > 0.0)),
        "raster_dropped_max": int(drops),
    }


if __name__ == "__main__":
    main()
