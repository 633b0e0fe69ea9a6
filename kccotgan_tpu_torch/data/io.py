"""Backend dispatch of the TFRecord IO: native C++ or pure Python.

Counterpart of ``kccotgan_tpu/data/io.py``.  The pure-Python backend
(``tfrecord.py``) is the semantics oracle; the native one
(``native_io.py`` over ``csrc/kccot_io.cc``) gives byte-identical
output and is used when it can be built, because framing and proto
parsing in Python hold the GIL and would starve the card's input
pipeline.

* ``KCCOT_FORCE_PY_IO`` set (the JAX package's variable): Python.
* Else a host C++ compiler on PATH (``$CXX``, else ``g++``): native.
  Its build or load failing raises, with the compiler's output; it never
  falls back to Python quietly.
* Else: Python.

The choice is made at each call (the library is built once, at the first
native call), never at import.
"""

from __future__ import annotations

import os
from typing import Iterator

from . import native_io as _native
from . import tfrecord as _py

__all__ = [
    "iter_tfrecord",
    "parse_example",
    "parse_example_arrays",
    "parse_sequence_example",
    "backend",
]


def _impl():
    if os.environ.get("KCCOT_FORCE_PY_IO") or not _native.available():
        return _py
    _native.load_library()
    return _native


def backend() -> str:
    """'native' or 'python'."""
    return "native" if _impl() is _native else "python"


def iter_tfrecord(path: str, *, verify_crc: bool = False) -> Iterator[bytes]:
    return _impl().iter_tfrecord(path, verify_crc=verify_crc)


def parse_example(record: bytes) -> dict:
    return _impl().parse_example(record)


def parse_example_arrays(record: bytes) -> dict:
    return _impl().parse_example_arrays(record)


def parse_sequence_example(record: bytes) -> tuple[dict, dict]:
    return _impl().parse_sequence_example(record)
