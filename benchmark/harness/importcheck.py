"""The run must not have loaded JAX or the JAX package: modules are
compared by their whole top-level name (the part before the first dot), so
`fenerf_tpu_torch`, the port, is not `fenerf_tpu`."""
from __future__ import annotations

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "fenerf_tpu"})


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden(module_names) -> list:
    """The forbidden top-level names among `module_names`, sorted."""
    return sorted({top_level(n) for n in module_names} & FORBIDDEN)
