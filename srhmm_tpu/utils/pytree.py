"""Frozen dataclasses registered as JAX pytrees.

`dataclass` makes a frozen dataclass whose fields are pytree children,
except those declared with `static_field()`, which become part of the
treedef (hashable metadata such as a covariance type or word names).
Instances gain `.replace(**changes)`.
"""

from __future__ import annotations

import dataclasses

import jax


def static_field(default=dataclasses.MISSING):
    """A field kept out of the pytree leaves (compared and hashed as part
    of the tree structure)."""
    return dataclasses.field(default=default, metadata={"static": True})


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if not f.metadata.get("static")],
        meta_fields=[f.name for f in fields if f.metadata.get("static")],
    )
    cls.replace = _replace
    return cls
