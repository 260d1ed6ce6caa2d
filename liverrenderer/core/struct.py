"""Frozen pytree dataclasses for scene and wavefront records.

`dataclass` turns a class into a frozen `dataclasses.dataclass` registered
with `jax.tree_util.register_dataclass`, so instances pass through `jit`,
`lax.scan`, `grad` and `shard_map`.  Fields declared with
`field(pytree_node=False)` are static: they are kept out of the leaves, go
into the tree definition and therefore key the `jax.jit` cache, so they must
be hashable.  `.replace(**updates)` returns a copy with fields swapped.
"""
from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """A dataclass field; `pytree_node=False` makes it static (aux data)."""
    return dataclasses.field(metadata={"pytree_node": pytree_node}, **kwargs)


def _replace(self, **updates):
    """Return a copy with the given fields replaced."""
    return dataclasses.replace(self, **updates)


def dataclass(cls):
    """Frozen dataclass registered as a JAX pytree."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    data, meta = [], []
    for f in dataclasses.fields(cls):
        (data if f.metadata.get("pytree_node", True) else meta).append(f.name)
    cls.replace = _replace
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    return cls
