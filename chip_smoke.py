"""Smoke test of the flagship frame on a GPU, checked against the references.

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # four cards: the sharded frame only

One card: (1) refuses any default backend other than a GPU; (2) builds each
of the five flagship variants at 1920x1080 with 1M particle slots, compiles
`frame_loop`, runs it once to prime and once timed, and checks the frame;
(3) compares the frame's stages with their plain references at full width:
scan shadows vs the cone-trace march, the voxel samplers vs the trilinear
gather, the tiled raster vs the scatter raster, the one-hot histogram vs
`jnp.bincount`.

Four cards: builds the `fast` flagship over a 4-device mesh, runs a few
frames sharded, and compares them in the same process with one card.

Every failed check exits non-zero and prints no result. The last line of
standard output is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from illuminant.core.config import QualitySettings
from illuminant.lighting import cone_trace as ct
from illuminant.lighting.scan_shadows import scan_cone_visibility
from illuminant.ops.tonemap import luminance
from illuminant.parallel import mesh as pmesh
from illuminant.particles.state import ParticleState
from illuminant.raster.particles import rasterize_additive
from illuminant.raster.tiled import (
    KERNEL_QUAD, TiledRasterConfig, rasterize_tiled_jit)
from illuminant.scenes import FLAGSHIP_VARIANTS, build_flagship
from illuminant.sdf import analytic, sampling
from illuminant.sdf import volume as vol
from illuminant.sdf.columns import build_column_maps, sample_columns
from illuminant.utils.compile_cache import enable_compile_cache
from illuminant.utils.histogram import (
    bucket_boundaries, bucket_index, compute_histogram)

HEIGHT, WIDTH, CAPACITY = 1080, 1920, 1 << 20
# Frames per frame_loop dispatch (the priming run and the timed run).
FRAMES = 8
# Raster bin overflow allowed per frame: 0.1% of the particle slots. The
# flagship's spawn path was tuned for no drops; a few are tolerated.
DROP_BOUND = CAPACITY // 1024


class SmokeFailure(Exception):
    """A check failed; the message says which and by how much."""


def check(ok: bool, message: str) -> None:
    if not ok:
        raise SmokeFailure(message)


def result_line(device, count: int) -> dict:
    return {"ok": True, "device": {"platform": device.platform,
                                   "kind": device.device_kind,
                                   "count": count}}


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


# -- phase 1: device --------------------------------------------------------

def device_phase():
    backend = jax.default_backend()
    devices = jax.devices()
    check(backend == "gpu" and len(devices) > 0,
          f"default backend is {backend!r} with {len(devices)} device(s); "
          "this smoke test runs on a GPU only")
    d = devices[0]
    print(f"device: platform={d.platform} kind={d.device_kind} "
          f"count={len(devices)}")
    print(f"nvidia-smi: {nvidia_smi()}")
    return d


# -- phase 2: flagship frames -----------------------------------------------

def _frame_args(scene):
    return (scene.system.state, jnp.asarray(0.5, jnp.float32),
            jax.random.key(0), scene.volume, scene.gbuffer,
            scene.sphere_lights, scene.environment.uniforms(),
            jnp.asarray(scene.spawner.spawn_max, jnp.int32))


def check_frame(img, state, drops, height, width, drop_bound):
    """The checks every flagship frame must pass; returns the live count."""
    check(img.shape == (height, width, 3) and img.dtype == jnp.uint8,
          f"image is {img.shape} {img.dtype}, want ({height}, {width}, 3) "
          "uint8")
    check(int(jnp.max(img)) > int(jnp.min(img)), "image is constant")
    check(bool(jnp.all(jnp.isfinite(state.position))),
          "non-finite particle position")
    live = int(jnp.sum(state.position[:, 3] > 0.0))
    check(live > 0, "no live particles")
    check(int(drops) <= drop_bound,
          f"raster dropped {int(drops)} > bound {drop_bound}")
    return live


def run_variant(name, kwargs, height=HEIGHT, width=WIDTH,
                capacity=CAPACITY, frames=FRAMES, drop_bound=DROP_BOUND):
    """Compile, prime and time one flagship variant; returns its numbers."""
    scene = build_flagship(height=height, width=width, capacity=capacity,
                           **kwargs)
    state, avg, key, *rest = _frame_args(scene)
    t0 = time.perf_counter()
    compiled = scene.frame_loop.lower(
        state, avg, key, *rest, jnp.asarray(0, jnp.int32),
        n_frames=frames).compile()
    compile_s = time.perf_counter() - t0
    img, state, avg, drops = jax.block_until_ready(
        compiled(state, avg, key, *rest, jnp.asarray(0, jnp.int32)))
    t0 = time.perf_counter()
    img, state, avg, drops = jax.block_until_ready(
        compiled(state, avg, key, *rest, jnp.asarray(frames, jnp.int32)))
    ms_per_frame = (time.perf_counter() - t0) * 1e3 / frames
    live = check_frame(img, state, drops, height, width, drop_bound)
    stats = jax.devices()[0].memory_stats() or {}
    row = {"variant": name, "compile_s": round(compile_s, 2),
           "ms_per_frame": round(ms_per_frame, 3), "live": live,
           "dropped_max": int(drops),
           "peak_bytes_in_use": stats.get("peak_bytes_in_use")}
    print("frame: " + json.dumps(row))
    return row


def flagship_phase():
    return [run_variant(name, kw) for name, kw in FLAGSHIP_VARIANTS.items()]


# -- phase 3: oracle comparisons --------------------------------------------

def _report(name, error, tol, precision, ok):
    print("oracle: " + json.dumps({"check": name, "error": error,
                                   "tolerance": tol,
                                   "precision": precision, "ok": ok}))
    check(ok, f"{name}: error {error} outside tolerance {tol}")


def _flagship_parts(height, width):
    """The `fast` analytic flagship (few particle slots: only its scene,
    G-buffer, lights and quality are read)."""
    return build_flagship(height=height, width=width, capacity=4096)


def check_scan_vs_march(height=HEIGHT, width=WIDTH):
    """Scan shadows of the flagship's 8 lights vs the exact march.

    Bound: mean |vis - march| < 0.05, the fast stack's bound
    (tests/test_scan_shadows.py, shadow_scale 0.5 + nomination 0.5)."""
    scene = _flagship_parts(height, width)
    lights = scene.sphere_lights
    quality = scene.config.quality
    vis = jax.jit(lambda vol, gb, ls: scan_cone_visibility(
        vol, gb, ls.position, ls.properties[:, 0], ls.properties[:, 1],
        quality, light_active=ls.active))(
            scene.volume, scene.gbuffer, lights)
    # The flat ground's shading points, lifted like the scan's endpoints
    # (SphereLightCore.fxh:151).
    shaded = scene.gbuffer.world_position() + jnp.asarray(
        [0.0, 0.0, 1.6], jnp.float32)
    enable = jnp.ones((height, width), bool)
    err = []
    for i in range(lights.position.shape[0]):
        march = ct.cone_trace_jit(
            scene.volume, lights.position[i], lights.properties[i, 0],
            lights.properties[i, 1], shaded, enable, QualitySettings())
        err.append(float(jnp.mean(jnp.abs(
            vis[i].astype(jnp.float32) - march))))
    mean_err = float(np.mean(err))
    _report("scan_vs_march", mean_err, 0.05,
            "f32 elementwise; bf16 visibility upsample by design",
            mean_err < 0.05)
    return mean_err


def _voxel_volume(height, width):
    """The voxel flagship's whole field (static + dynamic obstructions)
    and its obstructions' (centers, half-sizes)."""
    scene = _flagship_parts(height, width)
    obs = scene.environment.pack_obstructions()
    volume = vol.generate_volume(scene.sdf_config, obs)
    return volume, np.asarray(obs.centers), np.asarray(obs.sizes)


def _scattered_points(n, width, height, centers, sizes, seed=7):
    """n points: 3/4 uniform over the volume (plus a margin outside it),
    1/4 in boxes 8 units around the obstructions, so that near-surface
    statistics rest on many points."""
    rng = np.random.default_rng(seed)
    n_near = n // 4
    lo = np.asarray([-20.0, -20.0, -8.0], np.float32)
    span = np.asarray([width + 40.0, height + 40.0, 80.0], np.float32)
    far = rng.uniform(0, 1, (n - n_near, 3)) * span + lo
    pick = rng.integers(0, len(centers), n_near)
    half = np.abs(sizes[pick, :3]) + 8.0
    near = centers[pick, :3] + rng.uniform(-1, 1, (n_near, 3)) * half
    return jnp.asarray(np.concatenate([far, near]).astype(np.float32))


def check_voxel_samplers(height=HEIGHT, width=WIDTH, n_points=1 << 20):
    """The scattered voxel samplers vs the trilinear gather oracle.

    `scene_sample` on the SdfVolume (whichever path the platform table
    picks): |err| <= |ref| * 2^-7 + 0.05 everywhere and < 0.06 near
    surfaces (tests/test_sampling_fast.py). ColumnField maps (`_map_core`)
    near surfaces (|ref| < 4): median overestimate <= 0.25 and p99 < 4.5
    (tests/test_columns.py, ellipsoid contract), mean |err| < 0.7 (prism
    0.2 + coarse-pack 0.5 bounds of the same file)."""
    volume, centers, sizes = _voxel_volume(height, width)
    pts = _scattered_points(n_points, width, height, centers, sizes)
    interp = analytic._use_interp(n_points)
    ref = np.asarray(jax.jit(sampling.sample)(volume, pts))
    got = np.asarray(jax.jit(analytic.scene_sample)(volume, pts))
    err = np.abs(got - ref)
    near = np.abs(ref) < 4.0
    worst = float(np.max(err - (np.abs(ref) * 2.0 ** -7 + 0.05)))
    near_max = float(err[near].max())
    _report("voxel_sampler_" + ("interp" if interp else "gather"),
            {"max_excess_over_rel_bound": worst, "near_max": near_max},
            {"all": "|ref|*2^-7+0.05", "near_max": 0.06},
            "bf16 interpolation operands" if interp else "f32 gather",
            worst <= 0.0 and near_max < 0.06)

    cols = build_column_maps(volume)
    d_cols = np.asarray(jax.jit(sample_columns)(cols, pts))
    over = (d_cols - ref)[near]
    stats = {"median_over": float(np.median(over)),
             "p99_over": float(np.percentile(over, 99)),
             "mean_abs": float(np.mean(np.abs(over)))}
    _report("column_maps", stats,
            {"median_over": 0.25, "p99_over": 4.5, "mean_abs": 0.7},
            "bf16 map operand by design, f32 accumulate",
            stats["median_over"] <= 0.25 and stats["p99_over"] < 4.5
            and stats["mean_abs"] < 0.7)
    return stats


def random_particles(n, height, width, seed=0):
    """Quad-kernel test particles on the raster's 1/16-px payload grid."""
    rng = np.random.default_rng(seed)
    x = np.round(rng.uniform(-2, width + 2, n) * 16.0).astype(
        np.float32) / 16
    y = np.round(rng.uniform(-2, height + 2, n) * 16.0).astype(
        np.float32) / 16
    color = rng.uniform(0.0, 2.0, (n, 4)).astype(np.float32)
    size = rng.uniform(1.0, 7.0, n).astype(np.float32)
    live = rng.uniform(size=n) > 0.1
    return x, y, color, size, live


def check_raster(height=HEIGHT, width=WIDTH, n=1 << 20):
    """rasterize_tiled (quad kernel) vs the raster/particles.py scatter.

    Bounds of tests/test_tiled_raster.py: max |img - oracle| /
    max(|oracle|, 0.25) < 0.08, total energy within 1%. The oracle's f32
    scatter-add may sum in any order; that slack is ~1e-6 relative, far
    inside both bounds."""
    x, y, color, size, live = random_particles(n, height, width)
    cfg = TiledRasterConfig(height=height, width=width, tile=32,
                            bin_capacity=1024, apron=4, kernel=KERNEL_QUAD,
                            rgba8_colors=False)
    img, diag = rasterize_tiled_jit(
        cfg, jnp.asarray(x), jnp.asarray(y), jnp.asarray(color),
        jnp.asarray(size), jnp.asarray(live))
    check(int(diag["dropped"]) == 0,
          f"raster oracle run dropped {int(diag['dropped'])} particles")
    pos = np.stack([x, y, np.zeros_like(x), live.astype(np.float32)], -1)
    render_data = np.zeros((n, 4), np.float32)
    render_data[:, 0] = size
    state = ParticleState.empty(n).replace(
        position=jnp.asarray(pos), render_color=jnp.asarray(color),
        render_data=jnp.asarray(render_data))
    oracle = jax.jit(rasterize_additive, static_argnums=(1, 2),
                     static_argnames=("footprint", "rounded"))(
        state, height, width, footprint=11, rounded=False)
    img = np.asarray(img, np.float64)
    oracle = np.asarray(oracle, np.float64)
    rel = float(np.max(np.abs(img - oracle) / np.maximum(np.abs(oracle),
                                                         0.25)))
    energy = float(abs(img.sum() - oracle.sum()) / oracle.sum())
    _report("raster_vs_scatter", {"max_rel": rel, "energy": energy},
            {"max_rel": 0.08, "energy": 0.01},
            "bf16 one-hot splat operands by design, f32 accumulate",
            rel < 0.08 and energy < 0.01)
    return rel, energy


def check_histogram(height=HEIGHT, width=WIDTH, seed=1):
    """One-hot histogram counts vs jnp.bincount of the same buckets: exact."""
    rng = np.random.default_rng(seed)
    hdr = jnp.asarray(rng.lognormal(-0.5, 1.5, (height, width, 3)).astype(
        np.float32)).astype(jnp.bfloat16)
    bounds = bucket_boundaries(max_value=64.0)
    counts = np.asarray(jax.jit(
        lambda h: compute_histogram(h, bounds).counts)(hdr))
    lum = luminance(hdr[..., :3]).reshape(-1).astype(jnp.float32)
    want = np.asarray(jnp.bincount(
        bucket_index(lum, jnp.asarray(bounds)), length=len(bounds)))
    diff = int(np.abs(counts.astype(np.int64) - want).max())
    _report("histogram_vs_bincount", diff, 0, "integer counts", diff == 0)
    return diff


def oracle_phase():
    check_scan_vs_march()
    check_voxel_samplers()
    check_raster()
    check_histogram()


# -- phase 4 (--four-cards): sharded frame vs one card ----------------------

def _run_frames(scene, state, n_frames, mesh=None):
    _, avg, key, volume, gbuffer, lights, env_u, spawn = _frame_args(scene)
    if mesh is not None:
        gbuffer = pmesh.shard_gbuffer(gbuffer, mesh)
        state = pmesh.shard_particles(state, mesh)
        volume, lights, env_u = pmesh.replicate((volume, lights, env_u),
                                                mesh)
        key, avg, spawn = (jax.device_put(a, pmesh.replicated(mesh))
                           for a in (key, avg, spawn))
    imgs, times = [], []
    for i in range(n_frames):
        t0 = time.perf_counter()
        img, state, avg, _ = jax.block_until_ready(scene.frame(
            state, avg, jax.random.fold_in(key, i), volume, gbuffer,
            lights, env_u, spawn, frame_index=i))
        times.append(time.perf_counter() - t0)
        imgs.append(img)
    return imgs, state, float(avg), times


def four_cards_phase(height=HEIGHT, width=WIDTH, capacity=CAPACITY,
                     n_devices=4, n_frames=4):
    """Sharded `fast` flagship vs the one-card frame, in one process.

    Tolerance of tests/test_multichip.py: uint8 frames within 1, particle
    positions within rtol 1e-5 / atol 1e-4, exposure within 1e-4."""
    check(len(jax.devices()) >= n_devices,
          f"{len(jax.devices())} device(s), want {n_devices}")
    mesh = pmesh.make_mesh(n_devices)
    kw = dict(height=height, width=width, capacity=capacity,
              preset="fast", spawn_sub_rings=n_devices)
    one = build_flagship(**kw)
    many = build_flagship(mesh=mesh, **kw)
    copy = lambda s: jax.tree.map(jnp.copy, s.system.state)  # noqa: E731
    imgs_a, state_a, avg_a, t_a = _run_frames(one, copy(one), n_frames)
    imgs_b, state_b, avg_b, t_b = _run_frames(many, copy(many), n_frames,
                                              mesh=mesh)
    spans = len(imgs_b[-1].sharding.device_set)
    check(spans == n_devices,
          f"sharded frame spans {spans} devices, want {n_devices}")
    img_diff = max(int(np.abs(np.asarray(a, np.int32)
                              - np.asarray(b, np.int32)).max())
                   for a, b in zip(imgs_a, imgs_b))
    pa, pb = np.asarray(state_a.position), np.asarray(state_b.position)
    pos_excess = float(np.max(np.abs(pa - pb) - (1e-4 + 1e-5 * np.abs(pa))))
    avg_diff = abs(avg_a - avg_b)
    print("four_cards: " + json.dumps({
        "devices": spans, "frames": n_frames,
        "one_card_ms": [round(t * 1e3, 3) for t in t_a],
        "sharded_ms": [round(t * 1e3, 3) for t in t_b]}))
    _report("sharded_vs_one_card",
            {"img_max_diff": img_diff, "pos_max_excess": pos_excess,
             "avg_lum_diff": avg_diff},
            {"img_max_diff": 1, "pos": "rtol 1e-5 atol 1e-4",
             "avg_lum_diff": 1e-4},
            "same program precision on both sides",
            img_diff <= 1 and pos_excess <= 0.0 and avg_diff < 1e-4)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the sharded four-card comparison")
    args = parser.parse_args(argv)
    try:
        device = device_phase()
        enable_compile_cache()
        if args.four_cards:
            four_cards_phase()
        else:
            flagship_phase()
            oracle_phase()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps(result_line(device, len(jax.devices()))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
