"""Per-platform choices, made explicit.

A choice that depends on the machine (which sampler, how far to unroll a
scan) is a table keyed by `jax.default_backend()`. A platform missing
from the table is an error, so a new accelerator never inherits another
one's tuning silently.
"""

from __future__ import annotations

import jax


def platform_choice(table: dict, what: str):
    """`table[jax.default_backend()]`, or NotImplementedError naming `what`."""
    backend = jax.default_backend()
    if backend not in table:
        raise NotImplementedError(
            f"no {what} choice for platform {backend!r} "
            f"(known: {sorted(table)})")
    return table[backend]
