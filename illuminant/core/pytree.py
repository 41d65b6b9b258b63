"""Pytree dataclass plumbing.

The reference engine threads mutable state through C# objects and GPU render
targets (e.g. ParticleSystem's double-buffered BufferSets,
/root/reference/Illuminant/Particles/ParticleSystem.cs:73-146). This build
is functionally pure: all state lives in immutable pytree dataclasses that are
carried through jitted step functions, so XLA sees static structure and the
whole class of buffer-ring/recycling machinery disappears (SURVEY.md §5.2).

`pytree_dataclass` registers a frozen dataclass with JAX. Fields marked with
`static_field()` become auxiliary (hashable, trace-time constant) data; all
other fields are leaves/children.
"""

from __future__ import annotations

import dataclasses
from typing import Any, TypeVar

import jax

_T = TypeVar("_T")


def static_field(**kwargs: Any) -> Any:
    """A dataclass field treated as static (aux) pytree metadata."""
    metadata = dict(kwargs.pop("metadata", {}) or {})
    metadata["static"] = True
    return dataclasses.field(metadata=metadata, **kwargs)


def field(**kwargs: Any) -> Any:
    return dataclasses.field(**kwargs)


def pytree_dataclass(cls: type[_T] | None = None, **dc_kwargs: Any):
    """Decorator: frozen dataclass registered as a JAX pytree.

    Adds a `.replace(**updates)` method (functional update), mirroring how the
    reference mutates configuration objects in place.
    """

    def wrap(c: type[_T]) -> type[_T]:
        c = dataclasses.dataclass(frozen=True, **dc_kwargs)(c)
        data_fields = []
        meta_fields = []
        for f in dataclasses.fields(c):
            if f.metadata.get("static", False):
                meta_fields.append(f.name)
            else:
                data_fields.append(f.name)
        jax.tree_util.register_dataclass(
            c, data_fields=data_fields, meta_fields=meta_fields
        )

        def replace(self: _T, **updates: Any) -> _T:
            return dataclasses.replace(self, **updates)

        c.replace = replace  # type: ignore[attr-defined]
        return c

    if cls is None:
        return wrap
    return wrap(cls)


def named_scope(name: str):
    """Decorator: wrap a traced function in jax.named_scope — the
    RenderTrace.Marker analog (SURVEY.md §5.1); scopes show up in
    jax.profiler traces and HLO metadata."""

    def wrap(fn):
        import functools

        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with jax.named_scope(name):
                return fn(*args, **kwargs)

        return inner

    return wrap
