"""ParticleSystem.Render dispatcher (raster/render.py)."""

import numpy as np
import jax.numpy as jnp

from illuminant.particles.state import ParticleState
from illuminant.raster.render import (
    ParticleAppearance,
    render_particles,
)
from illuminant.raster.tiled import TiledRasterConfig


def _state(n=64, h=64, w=64, seed=0):
    rng = np.random.default_rng(seed)
    st = ParticleState.empty(n)
    pos = np.zeros((n, 4), np.float32)
    pos[:, 0] = rng.uniform(8, w - 8, n)
    pos[:, 1] = rng.uniform(8, h - 8, n)
    pos[:, 3] = 1.0
    rc = np.ones((n, 4), np.float32) * 0.8
    rd = np.zeros((n, 4), np.float32)
    rd[:, 0] = 4.0  # size
    return st.replace(position=jnp.asarray(pos),
                      render_color=jnp.asarray(rc),
                      render_data=jnp.asarray(rd))


def _cfg(**kw):
    kw.setdefault("apron", 4)
    return TiledRasterConfig(height=64, width=64, tile=32,
                             bin_capacity=64,
                             rgba8_colors=False, **kw)


def test_untextured_additive():
    img, diag = render_particles(_state(), _cfg())
    assert int(diag["dropped"]) == 0
    assert float(jnp.sum(img)) > 1.0


def test_z_to_y_projects_screen_y():
    st = _state(n=1)
    pos = np.zeros((1, 4), np.float32)
    pos[0] = [32.0, 40.0, 10.0, 1.0]
    st = st.replace(position=jnp.asarray(pos))
    img, _ = render_particles(st, _cfg(), z_to_y=1.0)
    img = np.asarray(img)
    # Screen y = 40 - 10 = 30.
    assert img[28:33, 30:35].sum() > img[38:43, 30:35].sum()


def test_textured_sprite_path():
    tex = np.zeros((16, 16), np.float32)
    tex[4:12, 4:12] = 1.0
    app = ParticleAppearance(texture=tex, size_min=3.0, size_max=8.0,
                             angle_bins=1, size_bins=2, rank=3)
    cfg = _cfg(apron=5)
    img, diag = render_particles(_state(), cfg, appearance=app)
    assert float(jnp.sum(img)) > 1.0
    assert "residual" in diag


def test_alpha_blend_with_dither():
    app = ParticleAppearance(dithered_opacity=True)
    img, _ = render_particles(_state(), _cfg(), appearance=app,
                              additive_blend=False)
    a = np.asarray(img[..., 3])
    vals = np.unique(np.round(a[a > 0], 5))
    assert set(vals) <= {1.0} or len(vals) < 10  # binary-ish coverage
