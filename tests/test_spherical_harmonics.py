"""SH9 GI probes vs analytic results (SphericalHarmonics.fxh parity)."""

import numpy as np
import jax.numpy as jnp

from illuminant.lighting.spherical_harmonics import (
    GIProbe,
    bake_probe_from_lights,
    fibonacci_sphere,
    irradiance,
    project_radiance,
    sh9_basis,
    sh_cosine_lobe,
)


def test_basis_matches_fxh_constants():
    d = jnp.asarray([0.0, 0.0, 1.0])
    b = np.asarray(sh9_basis(d))
    np.testing.assert_allclose(b[0], 0.282095, atol=1e-6)
    np.testing.assert_allclose(b[2], 0.488603, atol=1e-6)  # z band
    np.testing.assert_allclose(b[6], 0.315392 * 2.0, atol=1e-6)
    # Cosine lobe scales bands by (pi, 2pi/3, pi/4) (fxh:37-49).
    c = np.asarray(sh_cosine_lobe(d))
    np.testing.assert_allclose(c[0] / b[0], np.pi, rtol=1e-5)
    np.testing.assert_allclose(c[2] / b[2], 2 * np.pi / 3, rtol=1e-5)


def test_constant_environment_projects_to_constant_irradiance():
    # Uniform white radiance from every direction -> irradiance = 1 for
    # every normal (energy-preserving convention).
    dirs = jnp.asarray(fibonacci_sphere(512))
    rad = jnp.ones((512, 3), jnp.float32)
    sh = project_radiance(dirs, rad)
    for n in ([0, 0, 1], [1, 0, 0], [0.577, 0.577, 0.577]):
        e = np.asarray(irradiance(sh, jnp.asarray(n, jnp.float32)))
        np.testing.assert_allclose(e, 1.0, rtol=0.02)


def test_directional_lobe_peaks_toward_source():
    # All radiance from +z: irradiance highest for +z normal, ~0 for -z.
    dirs = jnp.asarray(fibonacci_sphere(2048))
    w = np.clip(np.asarray(dirs)[:, 2], 0, None) ** 16
    rad = jnp.asarray(np.stack([w] * 3, -1), jnp.float32)
    sh = project_radiance(dirs, rad)
    up = float(irradiance(sh, jnp.asarray([0.0, 0, 1]))[0])
    down = float(irradiance(sh, jnp.asarray([0.0, 0, -1]))[0])
    side = float(irradiance(sh, jnp.asarray([1.0, 0, 0]))[0])
    assert up > 4 * side > 0, (up, side)
    assert abs(down) < 0.12 * up, (down, up)


def test_bake_probe_from_lights():
    def radiance_fn(dirs):
        # A red glow from +x, dim blue ambient.
        w = jnp.clip(dirs[:, 0], 0.0, None)[:, None]
        return w * jnp.asarray([2.0, 0.1, 0.0]) + jnp.asarray(
            [0.0, 0.0, 0.2])

    probe = GIProbe(position=(10.0, 20.0, 5.0))
    probe.coefficients = bake_probe_from_lights(probe.position,
                                                radiance_fn)
    e_x = np.asarray(irradiance(probe.coefficients,
                                jnp.asarray([1.0, 0, 0])))
    e_nx = np.asarray(irradiance(probe.coefficients,
                                 jnp.asarray([-1.0, 0, 0])))
    assert e_x[0] > 3 * max(e_nx[0], 1e-3)  # red faces the glow
    assert e_x[2] > 0.05  # ambient blue everywhere
