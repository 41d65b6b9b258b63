"""Visual regression artifacts for the documented approximations.

Renders side-by-side comparisons so the numeric bounds in PERF.md have a
visual anchor:
  out/approx_scan_vs_march.png     exact cone march | scan | 8x |diff|
  out/approx_particle_light.png    full eval | strided subset | 8x |diff|

Runs on CPU. Usage: python tools/approx_artifacts.py
"""

from __future__ import annotations

import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from illuminant.core.config import QualitySettings  # noqa: E402
from illuminant.lighting import cone_trace as ct  # noqa: E402
from illuminant.lighting.environment import (  # noqa: E402
    LightObstruction,
    SphereLightSource,
)
from illuminant.lighting.scan_shadows import scan_visibility  # noqa: E402
from illuminant.sdf.analytic import pack_scene  # noqa: E402
from illuminant.utils.image import write_png  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "out")


def _triptych(a, b, label_scale=8.0):
    d = np.abs(a - b) * label_scale
    row = np.concatenate([a, b, d], axis=1)
    return np.clip(row, 0.0, 1.0)


def scan_vs_march():
    H, W = 192, 192
    scene = pack_scene([
        LightObstruction.box((96.0, 96.0, 18.0), (8.0, 28.0, 18.0)),
        LightObstruction.cylinder((140.0, 60.0, 24.0), (9.0, 9.0, 24.0)),
        LightObstruction.box((60.0, 140.0, 6.0), (14.0, 8.0, 6.0)),
    ])
    q = QualitySettings()
    light = jnp.asarray([[40.0, 100.0, 30.0]])
    vis_scan = np.asarray(scan_visibility(
        scene, H, W, light, jnp.asarray([7.0]), jnp.asarray([220.0]), q,
        pixel_z=jnp.zeros((H, W)),
    ))[0]
    ys, xs = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5,
                         indexing="ij")
    shaded = np.stack([xs, ys, np.zeros_like(xs)], -1).astype(np.float32)
    vis_march = np.asarray(ct.cone_trace(
        scene, light[0], jnp.float32(7.0), jnp.float32(220.0),
        jnp.asarray(shaded), jnp.ones((H, W), bool), q,
    ))
    img = _triptych(vis_march, vis_scan)
    write_png(os.path.join(OUT, "approx_scan_vs_march.png"), img)
    print(f"scan vs march: mean |diff| {np.abs(vis_scan - vis_march).mean():.4f} "
          f"max {np.abs(vis_scan - vis_march).max():.3f}")


def particle_light_subset():
    from illuminant.core.config import RendererConfig
    from illuminant.lighting import gbuffer as gbuf
    from illuminant.lighting.environment import LightingEnvironment
    from illuminant.lighting.particle_light import (
        ParticleLightSource,
        accumulate_particle_lights,
    )
    from illuminant.particles.state import ParticleState

    H, W = 192, 192
    env = LightingEnvironment(ground_z=0.0, maximum_z=64.0)
    gb = gbuf.flat_ground(H, W, env.uniforms())
    scene = pack_scene([])
    rng = np.random.default_rng(4)
    n = 512
    st = ParticleState.empty(n)
    pos = np.zeros((n, 4), np.float32)
    pos[:, 0] = rng.uniform(20, W - 20, n)
    pos[:, 1] = rng.uniform(20, H - 20, n)
    pos[:, 2] = 14.0
    pos[:, 3] = 1.0
    col = np.ones((n, 4), np.float32)
    col[:, :3] = rng.uniform(0.4, 1.0, (n, 3))
    st = st.replace(position=jnp.asarray(pos), color=jnp.asarray(col))
    template = SphereLightSource(radius=2.0, ramp_length=46.0,
                                 color=(1.0, 1.0, 1.0, 0.05),
                                 cast_shadows=False)
    q = QualitySettings()
    full = np.asarray(accumulate_particle_lights(
        scene, gb, st, ParticleLightSource(template=template,
                                           max_lights=512,
                                           method="subset"),
        env.uniforms(), q,
    ))[..., 0]
    sub = np.asarray(accumulate_particle_lights(
        scene, gb, st, ParticleLightSource(template=template,
                                           max_lights=128,
                                           method="subset"),
        env.uniforms(), q,
    ))[..., 0]
    hi = max(full.max(), 1e-6)
    img = _triptych(full / hi, sub / hi)
    write_png(os.path.join(OUT, "approx_particle_light.png"), img)
    rel = np.abs(sub - full).mean() / max(full.mean(), 1e-6)
    print(f"particle-light 4x subset: mean rel err {rel:.3f}")
    # The library DEFAULT for shadowless DISCRETE light sets (<= 2048)
    # is the exact tiled-light-culling path. This stress scene has ~170
    # lights overlapping every pixel (ramp 46 on a 192px screen), so
    # exactness needs a tile capacity above the measured 330/tile max.
    tiled = np.asarray(accumulate_particle_lights(
        scene, gb, st, ParticleLightSource(template=template,
                                           tile=32, tile_capacity=384),
        env.uniforms(), q,
    ))[..., 0]
    rel_t = np.abs(tiled - full).mean() / max(full.mean(), 1e-6)
    print(f"particle-light tiled (default): mean rel err {rel_t:.4f}")


if __name__ == "__main__":
    scan_vs_march()
    particle_light_subset()
