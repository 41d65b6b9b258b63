"""Scan refinement default: refine=1 is march-equivalent to refine=2.

The quantification behind QualitySettings.scan_refine_samples = 1: across
tall / short / mixed obstruction scenes, the second refinement candidate
changes the error vs the exact cone-trace march by < 0.006 mean absolute
visibility (and is byte-identical on most scenes).
"""

import numpy as np
import jax.numpy as jnp

from illuminant.core.config import QualitySettings
from illuminant.lighting import cone_trace as ct
from illuminant.lighting.environment import LightObstruction
from illuminant.lighting.scan_shadows import scan_visibility_jit
from illuminant.sdf.analytic import pack_scene

H, W = 96, 144

SCENES = {
    "tall": [LightObstruction.box((70, 48, 16), (4, 30, 16)),
             LightObstruction.cylinder((100, 70, 20), (8, 8, 20))],
    "short": [LightObstruction.box((70, 48, 4), (4, 30, 4)),
              LightObstruction.ellipsoid((100, 24, 6), (10, 8, 6))],
    "mixed": [LightObstruction.box((60, 30, 18), (5, 14, 18)),
              LightObstruction.box((80, 70, 5), (6, 16, 5))],
}

_MARCH_CACHE = {}


def _march_for(name, scene, lights, radii, ramps):
    """The exact march oracle is the expensive part of every test here;
    both tests march the same scenes — compute once per scene."""
    if name not in _MARCH_CACHE:
        ys, xs = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5,
                             indexing="ij")
        shaded = np.stack(
            [xs, ys, np.zeros_like(xs)], -1).astype(np.float32)
        _MARCH_CACHE[name] = np.stack([
            np.asarray(ct.cone_trace_jit(scene, lights[i], radii[i], ramps[i],
                                     jnp.asarray(shaded),
                                     jnp.ones((H, W), bool),
                                     QualitySettings()))
            for i in range(2)
        ])
    return _MARCH_CACHE[name]


def _errors(name, obs):
    scene = pack_scene(obs, group_capacity_round=1)
    lights = jnp.asarray([[30.0, 48.0, 24.0], [120.0, 20.0, 60.0]],
                         jnp.float32)
    radii = jnp.asarray([6.0, 5.0])
    ramps = jnp.asarray([200.0, 200.0])
    march = _march_for(name, scene, lights, radii, ramps)
    out = {}
    for r in (0, 1, 2):
        q = QualitySettings(scan_refine_samples=r)
        vis = np.asarray(scan_visibility_jit(scene, H, W, lights, radii,
                                         ramps, q,
                                         pixel_z=jnp.zeros((H, W))))
        out[r] = np.abs(vis - march).mean()
    return out


def test_nomination_half_scale_tracks_full_scale():
    """scan_nomination_scale=0.5 runs the sequential walk on a half-res
    grid but keeps refine + cone readout at full shadow resolution; the
    visibility must stay close to the full-scale scan AND not lose
    ground against the exact march (the parity preset's cheap-walk
    justification)."""
    for name, obs in SCENES.items():
        scene = pack_scene(obs, group_capacity_round=1)
        lights = jnp.asarray([[30.0, 48.0, 24.0], [120.0, 20.0, 60.0]],
                             jnp.float32)
        radii = jnp.asarray([6.0, 5.0])
        ramps = jnp.asarray([200.0, 200.0])
        march = _march_for(name, scene, lights, radii, ramps)
        vis = {}
        for nom in (1.0, 0.5, 0.25):
            q = QualitySettings(scan_refine_samples=1,
                                scan_nomination_scale=nom)
            vis[nom] = np.asarray(scan_visibility_jit(
                scene, H, W, lights, radii, ramps, q,
                pixel_z=jnp.zeros((H, W))))
        direct = np.abs(vis[0.5] - vis[1.0]).mean()
        assert direct < 0.03, (name, direct)
        # Against the exact march the half-scale nomination must not
        # lose ground (measured: it is slightly CLOSER on all three
        # scene classes — the coarse walk's bilinear k smooths the
        # arg-min's nearest-column quantization). The parity preset's
        # quarter scale (a 24x36 walk here — proportionally far coarser
        # than the 1080p parity row's 270x480) stays within a small
        # increment of the full-res walk.
        err_full = np.abs(vis[1.0] - march).mean()
        err_nom = np.abs(vis[0.5] - march).mean()
        err_q = np.abs(vis[0.25] - march).mean()
        assert err_nom <= err_full + 0.01, (name, err_full, err_nom)
        assert err_q <= err_full + 0.02, (name, err_full, err_q)


def test_refine_one_is_march_equivalent_to_two():
    for name, obs in SCENES.items():
        err = _errors(name, obs)
        # Bound re-measured after the round-3 unit/half-pixel fixes:
        # both tiers got closer to the march (tall: refine=1
        # 0.031->0.017, refine=2 0.019->0.010) and the tier gap is
        # ~0.006-0.007 — still "one extra full-res scene eval buys
        # under a hundredth of mean visibility".
        assert err[1] <= err[2] + 0.008, (name, err)
        # Refinement exists for 3D correctness: on SHORT obstructions the
        # flatland scan must be strictly worse than refined.
        if name == "short":
            assert err[0] > err[1] + 0.02, err
        # And refined stays close to the exact march overall.
        assert err[1] < 0.12, (name, err)
