"""Scene environment: uniforms + light-source containers.

Host side mirrors LightingEnvironment
(/root/reference/Illuminant/Lighting/LightingEnvironment.cs:13-49) — a
mutable scene container of lights/obstructions with GroundZ / MaximumZ /
ZToYMultiplier / Ambient. Device side, lights are packed into fixed-capacity
SoA pytrees per light family (one batched tensor axis replaces the
reference's 128-instances-per-draw chunking, LightingRenderer.cs:1149-1166).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Tuple

import numpy as np
import jax.numpy as jnp

from ..core.pytree import pytree_dataclass
from ..ops import sdf_primitives
from ..sdf.volume import SdfObstructions

# LightSourceRampMode (LightSource.cs:622-630).
RAMP_LINEAR = 0
RAMP_EXPONENTIAL = 1
RAMP_NONE = 2


@pytree_dataclass
class EnvironmentUniforms:
    """Uniforms.Environment equivalent (Uniforms.cs:15-77).

    All scalars are traced values so animation doesn't recompile.
    """

    ground_z: jnp.ndarray
    maximum_z: jnp.ndarray
    z_to_y_multiplier: jnp.ndarray
    light_occlusion: jnp.ndarray
    ambient: jnp.ndarray  # (4,) premultiplied ambient color

    @staticmethod
    def make(ground_z=0.0, maximum_z=128.0, z_to_y=0.0, light_occlusion=0.0,
             ambient=(0.0, 0.0, 0.0, 1.0)) -> "EnvironmentUniforms":
        return EnvironmentUniforms(
            ground_z=jnp.asarray(ground_z, jnp.float32),
            maximum_z=jnp.asarray(maximum_z, jnp.float32),
            z_to_y_multiplier=jnp.asarray(z_to_y, jnp.float32),
            light_occlusion=jnp.asarray(light_occlusion, jnp.float32),
            ambient=jnp.asarray(ambient, jnp.float32),
        )


@pytree_dataclass
class SphereLights:
    """SoA sphere lights (SphereLightSource, LightSource.cs:214-311),
    padded to a fixed capacity; `active` masks the pads.

    position: (L, 3); color: (L, 4) HDR, opacity pre-folded
    (LightingRenderer.cs light vertex build folds Opacity into color).
    properties x/y/z/w = radius, ramp_length, ramp_mode, cast_shadows —
    the shader's lightProperties packing (SphereLightCore.fxh:16).
    more x/y/z/w = ao_radius, distance_falloff, y_falloff_factor,
    ao_opacity (fxh:18).
    """

    position: jnp.ndarray
    color: jnp.ndarray
    properties: jnp.ndarray  # (L, 4)
    more: jnp.ndarray  # (L, 4)
    specular_color_power: jnp.ndarray  # (L, 4) = specular rgb + power
    active: jnp.ndarray  # (L,) f32 0/1
    # Optional ramp textures (SphereLightCore.fxh WithRamp epilogue:
    # rgb = ramp(pre_trace_opacity, (angle + offset) * rate)). None when
    # no light uses a ramp; (L, RH, RW, 3) otherwise with per-light
    # (offset, rate) in ramp_offset_rate.
    ramp_texture: object = None
    ramp_offset_rate: object = None

    @property
    def capacity(self) -> int:
        return self.position.shape[0]

    @staticmethod
    def empty(capacity: int) -> "SphereLights":
        L = capacity
        more = np.zeros((L, 4), np.float32)
        more[:, 2] = 1.0  # y falloff factor defaults to 1
        more[:, 3] = 1.0  # ao opacity defaults to 1
        return SphereLights(
            position=jnp.zeros((L, 3), jnp.float32),
            color=jnp.zeros((L, 4), jnp.float32),
            properties=jnp.zeros((L, 4), jnp.float32),
            more=jnp.asarray(more),
            specular_color_power=jnp.zeros((L, 4), jnp.float32),
            active=jnp.zeros((L,), jnp.float32),
        )


@dataclasses.dataclass
class SphereLightSource:
    """Host-side mutable sphere light (LightSource.cs:214-311)."""

    position: tuple = (0.0, 0.0, 0.0)
    radius: float = 0.0
    ramp_length: float = 1.0
    ramp_mode: int = RAMP_LINEAR
    color: tuple = (1.0, 1.0, 1.0, 1.0)
    opacity: float = 1.0
    cast_shadows: bool = True
    ambient_occlusion_radius: float = 0.0
    ambient_occlusion_opacity: float = 1.0
    falloff_y_factor: float = 1.0
    shadow_distance_falloff: Optional[float] = None
    specular_color: tuple = (0.0, 0.0, 0.0)
    specular_power: float = 2.0
    # Ramp texture (LightSource.cs TextureRef + offset/rate :58-103):
    # (RH, RW, 3) array; RH=1 gives the 1D distance-ramp variant.
    ramp_texture: Optional[object] = None
    ramp_offset: float = 0.0
    ramp_rate: float = 1.0
    # LightSource.BlendMode (LightSource.cs:65): how this light composes
    # onto the lightmap — "additive" (default), "subtractive"
    # (RenderStates.SubtractiveBlend, darkness lights), or "max"
    # (RenderStates.MaxBlendValue). The renderer batches same-blend
    # lights exactly like the reference's blend-keyed render states
    # (LightingRenderer.cs:206).
    blend_mode: str = "additive"


def pack_sphere_lights(lights: List[SphereLightSource],
                       capacity: Optional[int] = None) -> SphereLights:
    """Pack host lights into the SoA pytree (the LightVertex build,
    LightingRenderer.cs:1193-1446, minus instancing)."""
    n = len(lights)
    cap = capacity or max(n, 1)
    out_pos = np.zeros((cap, 3), np.float32)
    out_col = np.zeros((cap, 4), np.float32)
    out_props = np.zeros((cap, 4), np.float32)
    out_more = np.zeros((cap, 4), np.float32)
    out_more[:, 2] = 1.0
    out_more[:, 3] = 1.0
    out_spec = np.zeros((cap, 4), np.float32)
    out_active = np.zeros((cap,), np.float32)
    ramps = [l.ramp_texture for l in lights if l.ramp_texture is not None]
    out_ramp = None
    out_ramp_or = None
    if ramps:
        rh = max(r.shape[0] for r in ramps)
        rw = max(r.shape[1] for r in ramps)
        out_ramp = np.ones((cap, rh, rw, 3), np.float32)
        out_ramp_or = np.tile(
            np.asarray([0.0, 1.0, 0.0], np.float32), (cap, 1)
        )
    for i, l in enumerate(lights):
        out_pos[i] = l.position
        col = np.asarray(l.color, np.float32).copy()
        col[3] *= l.opacity
        out_col[i] = col
        out_props[i] = [
            l.radius,
            l.ramp_length,
            float(l.ramp_mode),
            1.0 if l.cast_shadows else 0.0,
        ]
        out_more[i] = [
            l.ambient_occlusion_radius,
            l.shadow_distance_falloff or 0.0,
            max(l.falloff_y_factor, 1e-3),
            l.ambient_occlusion_opacity,
        ]
        out_spec[i, :3] = l.specular_color
        out_spec[i, 3] = l.specular_power
        out_active[i] = 1.0
        if out_ramp is not None and l.ramp_texture is not None:
            t = np.asarray(l.ramp_texture, np.float32)[..., :3]
            out_ramp[i, : t.shape[0], : t.shape[1]] = t
            out_ramp_or[i] = [l.ramp_offset, l.ramp_rate, 1.0]
    return SphereLights(
        position=jnp.asarray(out_pos),
        color=jnp.asarray(out_col),
        properties=jnp.asarray(out_props),
        more=jnp.asarray(out_more),
        specular_color_power=jnp.asarray(out_spec),
        active=jnp.asarray(out_active),
        ramp_texture=(jnp.asarray(out_ramp) if out_ramp is not None
                      else None),
        ramp_offset_rate=(jnp.asarray(out_ramp_or)
                          if out_ramp_or is not None else None),
    )


@dataclasses.dataclass
class LightObstruction:
    """Host-side SDF obstruction (LightObstruction.cs:10-148).

    Mutating geometry (center/size/rotation/type) clears `is_valid`, and
    flipping `is_dynamic` sets `has_dynamicity_changed` — the renderer's
    auto-invalidation consumes these exactly like the reference's setters
    (LightObstruction.cs:22-120) feeding AutoInvalidateDistanceField
    (LightingRenderer.cs:1977-2015).
    """

    type: int = sdf_primitives.TYPE_BOX
    center: tuple = (0.0, 0.0, 0.0)
    size: tuple = (1.0, 1.0, 1.0)
    rotation: tuple = (0.0, 0.0, 0.0, 1.0)
    is_dynamic: bool = False

    def __setattr__(self, name, value):
        if name in ("center", "size", "rotation", "type") and \
                "center" in self.__dict__:
            object.__setattr__(self, "is_valid", False)
        if name == "is_dynamic" and "is_dynamic" in self.__dict__ and \
                self.__dict__["is_dynamic"] != value:
            object.__setattr__(self, "has_dynamicity_changed", True)
        object.__setattr__(self, name, value)

    _serial_counter = itertools.count()

    def __post_init__(self):
        object.__setattr__(self, "is_valid", False)  # new -> needs raster
        object.__setattr__(self, "has_dynamicity_changed", False)
        # Process-unique identity for the renderer's add/remove snapshot:
        # id() is recycled by the allocator, so a remove+add pair at the
        # same address would compare equal and skip field invalidation.
        object.__setattr__(self, "serial", next(self._serial_counter))

    @staticmethod
    def box(center, size, is_dynamic=False):
        return LightObstruction(sdf_primitives.TYPE_BOX, center, size,
                                is_dynamic=is_dynamic)

    @staticmethod
    def ellipsoid(center, size, is_dynamic=False):
        return LightObstruction(sdf_primitives.TYPE_ELLIPSOID, center, size,
                                is_dynamic=is_dynamic)

    @staticmethod
    def cylinder(center, size, is_dynamic=False):
        return LightObstruction(sdf_primitives.TYPE_CYLINDER, center, size,
                                is_dynamic=is_dynamic)


@dataclasses.dataclass
class LightingEnvironment:
    """Host scene container (LightingEnvironment.cs:13-49)."""

    lights: list = dataclasses.field(default_factory=list)
    obstructions: list = dataclasses.field(default_factory=list)
    height_volumes: list = dataclasses.field(default_factory=list)
    billboards: list = dataclasses.field(default_factory=list)
    ground_z: float = 0.0
    maximum_z: float = 128.0
    z_to_y_multiplier: float = 0.0
    ambient: tuple = (0.0, 0.0, 0.0, 1.0)
    light_occlusion: float = 0.0

    def uniforms(self) -> EnvironmentUniforms:
        return EnvironmentUniforms.make(
            ground_z=self.ground_z,
            maximum_z=self.maximum_z,
            z_to_y=self.z_to_y_multiplier,
            light_occlusion=self.light_occlusion,
            ambient=self.ambient,
        )

    def pack_obstructions(self, capacity: Optional[int] = None,
                          dynamic: Optional[bool] = None) -> SdfObstructions:
        """Pack obstructions; dynamic=True/False selects the partition
        (DynamicDistanceField semantics, SDF/DistanceField.cs:248-321)."""
        obs = self.obstructions
        if dynamic is not None:
            obs = [o for o in obs if o.is_dynamic == dynamic]
        return SdfObstructions.from_lists(
            types=[o.type for o in obs],
            centers=[o.center for o in obs],
            sizes=[o.size for o in obs],
            rotations=[o.rotation for o in obs],
            capacity=capacity,
        )


@dataclasses.dataclass
class ReplicatedLight:
    """Per-instance overrides (LightSource.cs:615-620)."""

    position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    radius: Optional[float] = None
    ramp_length: Optional[float] = None
    opacity: Optional[float] = None
    color: Optional[tuple] = None
    specular_color: Optional[tuple] = None
    specular_power: Optional[float] = None


@dataclasses.dataclass
class LightSourceReplicator:
    """Cheap mass instancing of a sphere-light template
    (LightSource.cs:601-613): here this is just SoA packing — the
    replicated set expands into the same batched SphereLights arrays the
    accumulator already consumes."""

    template: SphereLightSource = dataclasses.field(
        default_factory=SphereLightSource
    )
    lights: list = dataclasses.field(default_factory=list)

    def clear(self):
        self.lights.clear()

    def add(self, light: ReplicatedLight):
        self.lights.append(light)

    def expand(self) -> list:
        """-> list of SphereLightSource with overrides applied."""
        out = []
        t = self.template
        for r in self.lights:
            out.append(
                dataclasses.replace(
                    t,
                    position=r.position,
                    radius=r.radius if r.radius is not None else t.radius,
                    ramp_length=(r.ramp_length if r.ramp_length is not None
                                 else t.ramp_length),
                    opacity=(r.opacity if r.opacity is not None
                             else t.opacity),
                    color=tuple(r.color) if r.color is not None
                    else t.color,
                    specular_color=(tuple(r.specular_color)
                                    if r.specular_color is not None
                                    else t.specular_color),
                    specular_power=(r.specular_power
                                    if r.specular_power is not None
                                    else t.specular_power),
                )
            )
        return out
