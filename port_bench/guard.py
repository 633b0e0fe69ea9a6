"""The import guard: the benchmark measures the PyTorch port alone, so no
process it runs may hold JAX or the JAX package.  Module names are
compared by their top-level name (the part before the first dot) whole:
``kccotgan_tpu_torch`` begins with ``kccotgan_tpu`` and is allowed.  The
harness reads its own process and every rank it spawned, each once its
window has closed, and gives no result when any holds one (``refuse``)."""

from __future__ import annotations

import sys

__all__ = ["FORBIDDEN", "Forbidden", "forbidden_loaded", "refuse", "top_level"]

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "kccotgan_tpu"})


def top_level(module: str) -> str:
    return module.split(".", 1)[0]


def forbidden_loaded(modules=None) -> list[str]:
    """The loaded modules whose top-level name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if top_level(m) in FORBIDDEN)


class Forbidden(RuntimeError):
    """JAX or the JAX package was loaded in a process of the run."""


def refuse(found) -> None:
    """Raise ``Forbidden`` naming ``found`` (``"<process>: <module>"``), if
    it names anything."""
    if found:
        raise Forbidden("loaded in the run: " + ", ".join(found))
