"""ctypes bindings of the native TFRecord/proto reader (``csrc/kccot_io.cc``).

Counterpart of ``kccotgan_tpu/data/native_io.py``, with the API of the
pure-Python backend (``tfrecord.py``): ``iter_tfrecord``,
``parse_example``, ``parse_example_arrays``, ``parse_sequence_example``
and ``masked_crc32c``, whose outputs are byte-identical to that
backend's (``tests/test_torch_tfrecord.py``): an mmap'd framing walk,
SSE4.2 CRC32C and a single-pass C++ proto parse.  Each parsed record
owns its handle (``_Parsed``), so parses may run in the threads of
``pipeline.parallel_map``.  The library is built by the host C++
compiler at first use (``_build.load_io_library``); a failed build or
load raises.  ``io.py`` picks this backend when a compiler is on PATH.
"""

from __future__ import annotations

import ctypes
from typing import Iterator

import numpy as np

from .._build import cxx, load_io_library

__all__ = [
    "available",
    "load_library",
    "iter_tfrecord",
    "parse_example",
    "parse_example_arrays",
    "parse_sequence_example",
    "masked_crc32c",
]

_lib = None

u8p = ctypes.POINTER(ctypes.c_uint8)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    sigs = {
        "kc_masked_crc32c": (ctypes.c_uint32, [u8p, ctypes.c_int64]),
        "kc_reader_open": (ctypes.c_void_p, [ctypes.c_char_p, ctypes.c_int]),
        "kc_reader_close": (None, [ctypes.c_void_p]),
        "kc_reader_count": (ctypes.c_int64, [ctypes.c_void_p]),
        "kc_reader_record_len": (ctypes.c_int64, [ctypes.c_void_p, ctypes.c_int64]),
        "kc_reader_record": (u8p, [ctypes.c_void_p, ctypes.c_int64]),
        "kc_reader_error": (ctypes.c_char_p, [ctypes.c_void_p]),
        "kc_parse": (ctypes.c_void_p, [u8p, ctypes.c_int64]),
        "kc_parsed_free": (None, [ctypes.c_void_p]),
        "kc_num_features": (ctypes.c_int64, [ctypes.c_void_p]),
        "kc_feature_key": (ctypes.c_char_p, [ctypes.c_void_p, ctypes.c_int64]),
        "kc_feature_kind": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_char_p]),
        "kc_feature_len": (ctypes.c_int64, [ctypes.c_void_p, ctypes.c_char_p]),
        "kc_feature_floats": (
            ctypes.POINTER(ctypes.c_float),
            [ctypes.c_void_p, ctypes.c_char_p],
        ),
        "kc_feature_ints": (
            ctypes.POINTER(ctypes.c_int64),
            [ctypes.c_void_p, ctypes.c_char_p],
        ),
        "kc_feature_bytes_size": (
            ctypes.c_int64,
            [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64],
        ),
        "kc_feature_bytes_data": (
            u8p,
            [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64],
        ),
        "kc_num_feature_lists": (ctypes.c_int64, [ctypes.c_void_p]),
        "kc_feature_list_key": (ctypes.c_char_p, [ctypes.c_void_p, ctypes.c_int64]),
        "kc_feature_list_steps": (
            ctypes.c_int64,
            [ctypes.c_void_p, ctypes.c_char_p],
        ),
        "kc_flist_kind": (
            ctypes.c_int,
            [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64],
        ),
        "kc_flist_len": (
            ctypes.c_int64,
            [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64],
        ),
        "kc_flist_floats": (
            ctypes.POINTER(ctypes.c_float),
            [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64],
        ),
        "kc_flist_ints": (
            ctypes.POINTER(ctypes.c_int64),
            [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64],
        ),
        "kc_flist_bytes_size": (
            ctypes.c_int64,
            [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64],
        ),
        "kc_flist_bytes_data": (
            u8p,
            [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64],
        ),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def load_library() -> ctypes.CDLL:
    """The native library, built at first use, its functions typed (every
    pointer an explicit restype: ctypes' default int would cut a 64-bit
    address).  Raises if it cannot be built or loaded."""
    global _lib
    if _lib is None:
        _lib = _bind(load_io_library())
    return _lib


def available() -> bool:
    """Whether a host C++ compiler is on PATH to build the library."""
    return cxx() is not None


def _buf_ptr(data: bytes):
    return ctypes.cast(ctypes.c_char_p(data), u8p)


def masked_crc32c(data: bytes) -> int:
    lib = load_library()
    return int(lib.kc_masked_crc32c(_buf_ptr(data), len(data)))


def iter_tfrecord(path: str, *, verify_crc: bool = False) -> Iterator[bytes]:
    """Yield raw record payloads (native framing walk over an mmap)."""
    lib = load_library()
    h = lib.kc_reader_open(path.encode(), 1 if verify_crc else 0)
    if not h:
        raise IOError(f"cannot open tfrecord: {path}")
    try:
        err = lib.kc_reader_error(h)
        if err:  # a bad crc (only checked under verify_crc) or a truncated record
            raise IOError(f"{path}: {err.decode()}")
        n = lib.kc_reader_count(h)
        for i in range(n):
            length = lib.kc_reader_record_len(h, i)
            ptr = lib.kc_reader_record(h, i)
            yield ctypes.string_at(ptr, length)
    finally:
        lib.kc_reader_close(h)


class _Parsed:
    """RAII wrapper over a kc_parse handle."""

    def __init__(self, record: bytes):
        self._lib = load_library()
        self._h = self._lib.kc_parse(_buf_ptr(record), len(record))
        if not self._h:
            raise ValueError("malformed Example/SequenceExample record")

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.kc_parsed_free(self._h)
            self._h = None

    def _feature(self, key: bytes):
        lib, h = self._lib, self._h
        kind = lib.kc_feature_kind(h, key)
        n = lib.kc_feature_len(h, key)
        if kind == 1:
            return [
                ctypes.string_at(
                    lib.kc_feature_bytes_data(h, key, j),
                    lib.kc_feature_bytes_size(h, key, j),
                )
                for j in range(n)
            ]
        if kind == 2:
            ptr = lib.kc_feature_floats(h, key)
            return np.ctypeslib.as_array(ptr, shape=(n,)).astype(
                np.float32, copy=True
            ).tolist() if n else []
        if kind == 3:
            ptr = lib.kc_feature_ints(h, key)
            return np.ctypeslib.as_array(ptr, shape=(n,)).tolist() if n else []
        return []

    def features(self) -> dict:
        lib, h = self._lib, self._h
        out = {}
        for i in range(lib.kc_num_features(h)):
            key = lib.kc_feature_key(h, i)
            out[key.decode("utf-8")] = self._feature(key)
        return out

    def _feature_array(self, key: bytes):
        """Array-native feature read: float/int lists come back as a
        single numpy copy straight off the C++ buffers — no
        ``.tolist()`` round-trip (that parity-exact path costs ~ms per
        80k-float feature; this is ~µs)."""
        lib, h = self._lib, self._h
        kind = lib.kc_feature_kind(h, key)
        n = lib.kc_feature_len(h, key)
        if kind == 1:
            return [
                ctypes.string_at(
                    lib.kc_feature_bytes_data(h, key, j),
                    lib.kc_feature_bytes_size(h, key, j),
                )
                for j in range(n)
            ]
        if kind == 2:
            if not n:
                return np.zeros(0, np.float32)
            ptr = lib.kc_feature_floats(h, key)
            return np.ctypeslib.as_array(ptr, shape=(n,)).copy()
        if kind == 3:
            if not n:
                return np.zeros(0, np.int64)
            ptr = lib.kc_feature_ints(h, key)
            return np.ctypeslib.as_array(ptr, shape=(n,)).copy()
        return []

    def feature_arrays(self) -> dict:
        lib, h = self._lib, self._h
        out = {}
        for i in range(lib.kc_num_features(h)):
            key = lib.kc_feature_key(h, i)
            out[key.decode("utf-8")] = self._feature_array(key)
        return out

    def feature_lists(self) -> dict:
        lib, h = self._lib, self._h
        out = {}
        for i in range(lib.kc_num_feature_lists(h)):
            key = lib.kc_feature_list_key(h, i)
            steps = lib.kc_feature_list_steps(h, key)
            vals = []
            for s in range(steps):
                kind = lib.kc_flist_kind(h, key, s)
                n = lib.kc_flist_len(h, key, s)
                if kind == 1:
                    vals.append(
                        [
                            ctypes.string_at(
                                lib.kc_flist_bytes_data(h, key, s, j),
                                lib.kc_flist_bytes_size(h, key, s, j),
                            )
                            for j in range(n)
                        ]
                    )
                elif kind == 2:
                    ptr = lib.kc_flist_floats(h, key, s)
                    vals.append(
                        np.ctypeslib.as_array(ptr, shape=(n,)).tolist() if n else []
                    )
                elif kind == 3:
                    ptr = lib.kc_flist_ints(h, key, s)
                    vals.append(
                        np.ctypeslib.as_array(ptr, shape=(n,)).tolist() if n else []
                    )
                else:
                    vals.append([])
            out[key.decode("utf-8")] = vals
        return out


def parse_example(record: bytes) -> dict:
    """tf.train.Example -> {feature_name: list} (native parse)."""
    return _Parsed(record).features()


def parse_example_arrays(record: bytes) -> dict:
    """tf.train.Example -> {feature_name: list[bytes] | np array}
    (native parse, array-native numeric features)."""
    return _Parsed(record).feature_arrays()


def parse_sequence_example(record: bytes) -> tuple[dict, dict]:
    """tf.train.SequenceExample -> (context, feature_lists) (native parse)."""
    p = _Parsed(record)
    return p.features(), p.feature_lists()
