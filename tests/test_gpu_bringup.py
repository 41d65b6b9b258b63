"""Per-platform choices, the compile-cache helper, PNG IO and chip_smoke.py.

chip_smoke.py's card-only phases run on the GPU; here its device phase
must refuse the CPU, its result line must carry exactly the contract's
keys, and every oracle comparison must pass at a small size.
"""

import json
import os
import shutil
import struct
import subprocess
import sys
import zlib

import jax
import numpy as np
import pytest

import chip_smoke as cs
from illuminant.lighting import scan_shadows
from illuminant.sdf import analytic
from illuminant.utils import compile_cache
from illuminant.utils.image import read_png, write_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- per-platform tables ----------------------------------------------------

@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_interp_choice_follows_platform_table(monkeypatch, platform):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    n = analytic._INTERP_MIN_POINTS
    assert analytic._use_interp(n) is analytic.INTERP_BY_PLATFORM[platform]
    assert analytic._use_interp(n - 1) is False
    with analytic.interp_dispatch("always"):
        assert analytic._use_interp(n) is True
    with analytic.interp_dispatch("never"):
        assert analytic._use_interp(n) is False


def test_interp_choice_unknown_platform_raises(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(NotImplementedError, match="scattered voxel"):
        analytic._use_interp(analytic._INTERP_MIN_POINTS)
    # Explicit overrides and small batches never consult the table.
    with analytic.interp_dispatch("always"):
        assert analytic._use_interp(analytic._INTERP_MIN_POINTS) is True
    assert analytic._use_interp(16) is False


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_scan_unroll_follows_platform_table(monkeypatch, platform):
    monkeypatch.delenv("ILLUM_SCAN_UNROLL", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert scan_shadows._default_unroll() == \
        scan_shadows.SCAN_UNROLL_BY_PLATFORM[platform]
    assert scan_shadows.SCAN_UNROLL_BY_PLATFORM["cpu"] == 1


def test_scan_unroll_unknown_platform_raises_unless_overridden(monkeypatch):
    monkeypatch.delenv("ILLUM_SCAN_UNROLL", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(NotImplementedError, match="scan unroll"):
        scan_shadows._default_unroll()
    monkeypatch.setenv("ILLUM_SCAN_UNROLL", "4")
    assert scan_shadows._default_unroll() == 4


# -- compile cache ----------------------------------------------------------

def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert calls == []  # JAX reads the variable itself


def test_compile_cache_default_is_stable_in_checkout(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == compile_cache.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)] * 2
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


# -- PNG IO -----------------------------------------------------------------

@pytest.mark.parametrize("shape", [(7, 5), (6, 9, 3), (4, 3, 4)])
def test_png_round_trip(tmp_path, shape):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / "a.png")
    write_png(path, img)
    back = read_png(path)
    assert back.dtype == np.uint8
    np.testing.assert_array_equal(back, img)


def test_png_float_input_is_scaled(tmp_path):
    img = np.linspace(0.0, 1.0, 12, dtype=np.float32).reshape(2, 2, 3)
    path = str(tmp_path / "f.png")
    write_png(path, img)
    np.testing.assert_array_equal(
        read_png(path), np.round(img * 255.0).astype(np.uint8))


def _filtered_png(img, filters):
    """Encode an (H, W, 3) uint8 image with the given per-row PNG filter
    types (0-4), as another writer might."""
    h, w, c = img.shape
    raw = img.reshape(h, w * c).astype(np.int32)
    rows = []
    for y in range(h):
        cur = raw[y]
        up = raw[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        ul = np.concatenate([np.zeros(c, np.int32), up[:-c]])
        f = filters[y]
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = up
        elif f == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        rows.append(bytes([f]) + ((cur - pred) & 0xFF).astype(
            np.uint8).tobytes())

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


def test_png_reader_undoes_every_filter(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (10, 7, 3), dtype=np.uint8)
    path = tmp_path / "filtered.png"
    path.write_bytes(_filtered_png(img, [0, 1, 2, 3, 4, 4, 3, 2, 1, 0]))
    np.testing.assert_array_equal(read_png(str(path)), img)


# -- chip_smoke.py ----------------------------------------------------------

def test_smoke_device_phase_refuses_cpu():
    with pytest.raises(cs.SmokeFailure, match="GPU only"):
        cs.device_phase()


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_smoke_script_exits_nonzero_on_cpu():
    out = _run_smoke(REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "GPU only" in out.stderr


def test_smoke_script_alone_exits_nonzero(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run_smoke(str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_smoke_result_line_has_exactly_the_contract_keys():
    class Dev:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    line = json.loads(json.dumps(cs.result_line(Dev(), 1)))
    assert line == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


def _good_frame(h=8, w=16):
    import jax.numpy as jnp

    from illuminant.particles.state import ParticleState

    img = jnp.arange(h * w * 3, dtype=jnp.int32).reshape(h, w, 3)
    state = ParticleState.empty(4)
    state = state.replace(position=state.position.at[:, 3].set(1.0))
    return img.astype(jnp.uint8), state


@pytest.mark.parametrize("fault", ["shape", "constant", "nan", "dead",
                                   "drops"])
def test_smoke_frame_checks_catch_each_fault(fault):
    import jax.numpy as jnp

    img, state = _good_frame()
    assert cs.check_frame(img, state, 0, 8, 16, drop_bound=0) == 4
    drops = 0
    if fault == "shape":
        img = img[:, :8]
    elif fault == "constant":
        img = jnp.zeros_like(img)
    elif fault == "nan":
        state = state.replace(position=state.position.at[0, 0].set(jnp.nan))
    elif fault == "dead":
        state = state.replace(position=state.position.at[:, 3].set(0.0))
    else:
        drops = 1
    with pytest.raises(cs.SmokeFailure):
        cs.check_frame(img, state, drops, 8, 16, drop_bound=0)


def test_smoke_histogram_oracle_small():
    assert cs.check_histogram(64, 128) == 0


def test_smoke_raster_oracle_small():
    rel, energy = cs.check_raster(64, 128, 4096)
    assert rel < 0.08 and energy < 0.01


def test_smoke_voxel_sampler_oracles_few_points():
    stats = cs.check_voxel_samplers(1080, 1920, 1 << 14)
    assert stats["p99_over"] < 4.5


def test_smoke_scan_vs_march_oracle_small():
    assert cs.check_scan_vs_march(270, 480) < 0.05


def test_smoke_variant_small():
    row = cs.run_variant("fast", dict(preset="fast"), height=64, width=128,
                         capacity=4096, frames=2, drop_bound=4)
    assert row["live"] > 0 and row["ms_per_frame"] > 0


def test_smoke_four_cards_phase_on_virtual_devices():
    cs.four_cards_phase(height=64, width=128, capacity=4096, n_frames=2)
