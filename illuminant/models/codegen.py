"""SaveAsCode: compile an EngineModel to explicit construction code.

The reference's Model.Codegen.cs (~600 LoC, invoked from Model.cs:122-132)
emits a C# class that reconstructs every system, transform, and named
variable with explicit constructor calls — the "compiled model" path that
TestGame's LoadCompiledModel scene builds against (TestGame.cs:93-95).

This is the Python equivalent: `save_as_code` walks the model through the
same instantiation mapping the live binding uses (view.py) and emits a
standalone module whose `build_systems(volume=None, capacity=None)`
constructs the ParticleSystemConfig / Spawner / transform objects
DIRECTLY — no JSON parsing, no property-bag reflection at load time.
Fidelity contract: exec(code).build_systems() steps bit-identically to
EngineView(model) (tests/test_codegen.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List

import numpy as np

from .model import EngineModel
from .view import instantiate_transform, system_config_from_model

_HEADER = '''"""Machine-generated by illuminant.models.codegen.save_as_code
from {source!r} — edit the scene, not this file."""

from illuminant.particles.formula import Formula1, Formula3, Formula4
from illuminant.particles.spawner import Spawner
from illuminant.particles.system import (
    ParticleSystem,
    ParticleSystemConfig,
)
from illuminant.particles.transforms import (
    FMA,
    Attractor,
    GeometricTransform,
    Gravity,
    MatrixMultiply,
    Noise,
    Sensor,
    TransformArea,
    VectorField,
)

import numpy as np

NAMED_VARIABLES = {named_variables}


def build_systems(volume=None, capacity=None):
    """Construct the model's live systems explicitly (no JSON)."""
    systems = []
{body}
    return systems
'''


def _emit(value: Any, indent: int = 0) -> str:
    """Emit a constructor expression for a host-side config value."""
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        cls = type(value).__name__
        args = []
        for f in dataclasses.fields(value):
            v = getattr(value, f.name)
            d = f.default
            if d is not dataclasses.MISSING and _equal(v, d):
                continue  # omit defaults for readable output
            if d is dataclasses.MISSING and \
                    f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
                if _equal(v, f.default_factory()):  # type: ignore[misc]
                    continue
            args.append(f"{f.name}={_emit(v)}")
        return f"{cls}({', '.join(args)})"
    if isinstance(value, (np.floating, np.integer)):
        return repr(value.item())
    if isinstance(value, np.ndarray):
        return f"np.array({value.tolist()!r}, np.float32)"
    if isinstance(value, tuple):
        inner = ", ".join(_emit(v) for v in value)
        return f"({inner},)" if len(value) == 1 else f"({inner})"
    if isinstance(value, list):
        return "[" + ", ".join(_emit(v) for v in value) + "]"
    if isinstance(value, (bool, int, str, type(None))):
        return repr(value)
    if isinstance(value, float):
        return repr(value)
    raise TypeError(
        f"save_as_code cannot emit {type(value).__name__}: {value!r}"
    )


def _equal(a, b) -> bool:
    try:
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            return bool(np.array_equal(a, b))
        return bool(a == b)
    except Exception:
        return False


def save_as_code(model: EngineModel, writer=None) -> str:
    """Emit the compiled-model module source (and write it if `writer`)."""
    resolver = model.make_resolver()
    body_lines: List[str] = []
    for sm in sorted(model.systems, key=lambda s: s.update_order):
        body_lines.append(f"    # -- system {sm.name!r} --")
        config = system_config_from_model(sm)
        body_lines.append(
            "    config = dataclasses_replace_capacity("
            f"{_emit(config)}, capacity)"
        )
        body_lines.append("    transforms = [")
        for tm in sm.transforms:
            live = instantiate_transform(tm, resolver)
            body_lines.append(f"        {_emit(live)},")
        body_lines.append("    ]")
        body_lines.append(
            "    systems.append(ParticleSystem(config, transforms, "
            "volume=volume))"
        )

    named = {
        name: (
            defn.default_value.evaluate(0.0, resolver).tolist(),
            defn.is_external,
        )
        for name, defn in model.named_variables.items()
    }

    src = _HEADER.format(
        source=model.filename or "<memory>",
        named_variables=repr(named),
        body="\n".join(body_lines) if body_lines else "    pass",
    )
    src += '''

def dataclasses_replace_capacity(config, capacity):
    if capacity is None:
        return config
    import dataclasses

    return dataclasses.replace(config, capacity=capacity)
'''
    if writer is not None:
        writer.write(src)
    return src
