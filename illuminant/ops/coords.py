"""Normal encoding and small geometry helpers.

Spherical normal encode/decode matches
/root/reference/Illuminant/Shaders/EnvironmentCommon.fxh:34-52 (the g-buffer
stores normals as two spherical-coordinate channels; an all-zero encoding
means "no normal" and decodes to the zero vector, which downstream lighting
treats as "directional occlusion disabled", LightCommon.fxh:129-131).

In this build the g-buffer is a struct of planar arrays so we could store
raw normals, but we keep the encoded form available for golden tests against
reference captures and for compact storage.
"""

from __future__ import annotations

import jax.numpy as jnp


def encode_normal_spherical(n):
    """(..., 3) unit normals -> (..., 2) in [0, 1]."""
    nx = jnp.where(jnp.abs(n[..., 0]) < 1e-4, 1e-4, n[..., 0])
    ang = jnp.arctan2(n[..., 1], nx) / jnp.pi
    return (jnp.stack([ang, n[..., 2]], axis=-1) + 1.0) * 0.5


def decode_normal_spherical(enc):
    """(..., 2) -> (..., 3); all-zero encoding decodes to the zero vector."""
    ang = enc * 2.0 - 1.0
    s = jnp.sin(ang[..., 0] * jnp.pi)
    c = jnp.cos(ang[..., 0] * jnp.pi)
    z = ang[..., 1]
    r = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    n = jnp.stack([c * r, s * r, z], axis=-1)
    is_zero = jnp.all(enc == 0.0, axis=-1, keepdims=True)
    return jnp.where(is_zero, 0.0, n)


def normalize(v, axis=-1, eps=1e-20):
    return v / jnp.sqrt(
        jnp.maximum(jnp.sum(v * v, axis=axis, keepdims=True), eps)
    )


def vlength(v, axis=-1):
    return jnp.sqrt(jnp.sum(v * v, axis=axis))


def mul_point_rows(v4, matrix):
    """mul(float4(v.xyz, 1), M) keeping the original w — the row-vector
    point transform shared by spawners (SpawnerCommon.fxh:166-180) and
    particle matrix transforms (ParticleCommon.fxh mul3 :187).

    Written as explicit row combinations, NOT a matmul: a (N, 4) @ (4, 4)
    jnp.dot at default precision may run reduced-precision (bf16 or TF32)
    products, visibly quantizing positions/velocities. Element-wise ops
    keep f32.
    """
    out = (
        v4[:, 0:1] * matrix[0, :3]
        + v4[:, 1:2] * matrix[1, :3]
        + v4[:, 2:3] * matrix[2, :3]
        + matrix[3, :3]
    )
    return jnp.concatenate([out, v4[:, 3:4]], axis=-1)


def stipple_keep(count_or_slots, factor, offset=0.0):
    """StippleReject keep mask (RasterizeParticleSystem.fx:101-110):
    deterministic golden-ratio fraction of slots. Shared by the
    rasterizers and particle lights."""
    import jax.numpy as jnp

    slots = (jnp.arange(count_or_slots, dtype=jnp.float32)
             if isinstance(count_or_slots, int) else
             count_or_slots.astype(jnp.float32))
    return jnp.mod(slots * 0.6180339887 + offset, 1.0) < factor
