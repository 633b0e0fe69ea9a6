"""TFRecord framing and the ``tf.train.Example`` / ``SequenceExample``
wire format, in pure Python.

Counterpart of ``kccotgan_tpu/data/tfrecord.py``, the same code: a
TFRecord is a framed container (8-byte LE length, masked CRC32C of the
length, payload, masked CRC32C of the payload), and the two messages are
parsed with a minimal protobuf wire-format reader that knows exactly
their field tree:

  Example          { Features features = 1 }
  SequenceExample  { Features context = 1; FeatureLists feature_lists = 2 }
  Features         { map<string, Feature> feature = 1 }
  FeatureLists     { map<string, FeatureList> feature_list = 1 }
  FeatureList      { repeated Feature feature = 1 }
  Feature          { BytesList=1 | FloatList=2 | Int64List=3 }

This is the portable backend and the semantics oracle of the native
reader (``csrc/kccot_io.cc`` through ``native_io.py``); ``io.py`` picks
between them.  The encoders write the fixtures of the tests and of
``chip_smoke.py``.
"""

from __future__ import annotations

import os
import struct
from typing import Iterator

__all__ = [
    "iter_tfrecord",
    "parse_example",
    "parse_example_arrays",
    "parse_sequence_example",
    "masked_crc32c",
    "write_tfrecord",
    "encode_example",
    "encode_sequence_example",
]

# ------------------------------------------------------------------ crc32c

_CRC_TABLE = None


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78  # Castagnoli, reflected
        table = []
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------------------ framing


def iter_tfrecord(path: str, *, verify_crc: bool = False) -> Iterator[bytes]:
    """Yield raw record payloads from a TFRecord file."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            if verify_crc:
                (len_crc,) = struct.unpack("<I", header[8:12])
                if masked_crc32c(header[:8]) != len_crc:
                    raise IOError(f"{path}: corrupt length crc")
            data = f.read(length)
            if len(data) < length:
                raise IOError(f"{path}: truncated record")
            data_crc_bytes = f.read(4)
            if verify_crc:
                (data_crc,) = struct.unpack("<I", data_crc_bytes)
                if masked_crc32c(data) != data_crc:
                    raise IOError(f"{path}: corrupt data crc")
            yield data


# ------------------------------------------------------------ proto parsing


def _to_signed64(x: int) -> int:
    """int64 fields arrive as unsigned varints; recover the sign."""
    return x - (1 << 64) if x >= (1 << 63) else x


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes) -> Iterator[tuple[int, int, bytes | int]]:
    """Yield (field_number, wire_type, value) triples.  Length-delimited
    fields yield bytes; varint fields yield ints; fixed32/64 yield bytes."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 2:  # length-delimited
            length, pos = _read_varint(buf, pos)
            val = buf[pos : pos + length]
            pos += length
        elif wire == 5:  # fixed32
            val = buf[pos : pos + 4]
            pos += 4
        elif wire == 1:  # fixed64
            val = buf[pos : pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_feature(buf: bytes):
    """Feature -> list of bytes | list of float | list of int."""
    for field, wire, val in _iter_fields(buf):
        if field == 1:  # BytesList
            return [v for f, _, v in _iter_fields(val) if f == 1]
        if field == 2:  # FloatList (packed or repeated)
            floats: list[float] = []
            for f, w, v in _iter_fields(val):
                if f != 1:
                    continue
                if w == 2:  # packed
                    floats.extend(
                        struct.unpack(f"<{len(v) // 4}f", v)
                    )
                else:  # unpacked fixed32
                    floats.append(struct.unpack("<f", v)[0])
            return floats
        if field == 3:  # Int64List
            ints: list[int] = []
            for f, w, v in _iter_fields(val):
                if f != 1:
                    continue
                if w == 2:  # packed varints
                    pos = 0
                    while pos < len(v):
                        x, pos = _read_varint(v, pos)
                        ints.append(_to_signed64(x))
                else:
                    ints.append(_to_signed64(v))
            return ints
    return []


def _parse_features_map(buf: bytes) -> dict:
    """Features -> {name: parsed Feature}."""
    out = {}
    for field, _, entry in _iter_fields(buf):
        if field != 1:
            continue
        key, feat = None, []
        for f, _, v in _iter_fields(entry):
            if f == 1:
                key = v.decode("utf-8")
            elif f == 2:
                feat = _parse_feature(v)
        if key is not None:
            out[key] = feat
    return out


def parse_example(record: bytes) -> dict:
    """tf.train.Example -> {feature_name: list}."""
    for field, _, val in _iter_fields(record):
        if field == 1:
            return _parse_features_map(val)
    return {}


def _parse_feature_arrays(buf: bytes):
    """Feature -> list[bytes] | np.float32 array | np.int64 array.

    The array-native variant of ``_parse_feature``: packed FloatLists
    decode via ``np.frombuffer`` (zero Python-object churn) instead of
    ``struct.unpack`` into a list — the difference between ~ms and ~µs
    per video for flat-float features of H*W*T*C size (the 'animation'
    format), which is what lets the host pipeline keep a TPU fed.
    """
    import numpy as np

    for field, wire, val in _iter_fields(buf):
        if field == 1:  # BytesList
            return [v for f, _, v in _iter_fields(val) if f == 1]
        if field == 2:  # FloatList (packed or repeated)
            chunks = [
                np.frombuffer(v, "<f4")
                for f, w, v in _iter_fields(val)
                if f == 1
            ]
            if not chunks:
                return np.zeros(0, np.float32)
            return chunks[0] if len(chunks) == 1 else np.concatenate(chunks)
        if field == 3:  # Int64List
            ints: list[int] = []
            for f, w, v in _iter_fields(val):
                if f != 1:
                    continue
                if w == 2:  # packed varints
                    pos = 0
                    while pos < len(v):
                        x, pos = _read_varint(v, pos)
                        ints.append(_to_signed64(x))
                else:
                    ints.append(_to_signed64(v))
            return np.asarray(ints, np.int64)
    return []


def parse_example_arrays(record: bytes) -> dict:
    """tf.train.Example -> {feature_name: list[bytes] | np array}.

    Like ``parse_example`` but float/int features come back as numpy
    arrays (float32 / int64) — the fast path for loaders that consume
    large numeric features."""
    for field, _, val in _iter_fields(record):
        if field != 1:
            continue
        out = {}
        for f, _, entry in _iter_fields(val):
            if f != 1:
                continue
            key, feat = None, []
            for ff, _, vv in _iter_fields(entry):
                if ff == 1:
                    key = vv.decode("utf-8")
                elif ff == 2:
                    feat = _parse_feature_arrays(vv)
            if key is not None:
                out[key] = feat
        return out
    return {}


def parse_sequence_example(record: bytes) -> tuple[dict, dict]:
    """tf.train.SequenceExample -> (context {name: list},
    feature_lists {name: [list, ...]})."""
    context: dict = {}
    feature_lists: dict = {}
    for field, _, val in _iter_fields(record):
        if field == 1:
            context = _parse_features_map(val)
        elif field == 2:
            for f, _, entry in _iter_fields(val):
                if f != 1:
                    continue
                key, feats = None, []
                for ff, _, vv in _iter_fields(entry):
                    if ff == 1:
                        key = vv.decode("utf-8")
                    elif ff == 2:
                        feats = [
                            _parse_feature(x)
                            for fff, _, x in _iter_fields(vv)
                            if fff == 1
                        ]
                if key is not None:
                    feature_lists[key] = feats
    return context, feature_lists


# ---------------------------------------------------------- proto encoding
# Minimal writers — used for synthetic dataset fixtures (tests never need
# real downloads) and by the dataset-conversion CLI.


def _varint(x: int) -> bytes:
    # negative int64s encode as 10-byte two's-complement varints
    x &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = x & 0x7F
        x >>= 7
        if x:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _len_field(field: int, payload: bytes) -> bytes:
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


def _encode_feature(value) -> bytes:
    """list[bytes] -> BytesList; list[float] -> FloatList (packed);
    list[int] -> Int64List (packed)."""
    if not value:
        return b""
    if isinstance(value[0], (bytes, bytearray)):
        inner = b"".join(_len_field(1, bytes(v)) for v in value)
        return _len_field(1, inner)
    if isinstance(value[0], float):
        packed = struct.pack(f"<{len(value)}f", *value)
        return _len_field(2, _len_field(1, packed))
    packed = b"".join(_varint(int(v)) for v in value)
    return _len_field(3, _len_field(1, packed))


def _encode_features_map(features: dict) -> bytes:
    out = bytearray()
    for key, value in features.items():
        entry = _len_field(1, key.encode("utf-8")) + _len_field(
            2, _encode_feature(value)
        )
        out += _len_field(1, entry)
    return bytes(out)


def encode_example(features: dict) -> bytes:
    """{name: list[bytes|float|int]} -> serialized tf.train.Example."""
    return _len_field(1, _encode_features_map(features))


def encode_sequence_example(context: dict, feature_lists: dict | None = None) -> bytes:
    """-> serialized tf.train.SequenceExample.  ``feature_lists`` maps
    name -> list of per-step feature value lists."""
    out = _len_field(1, _encode_features_map(context))
    if feature_lists:
        fl = bytearray()
        for key, steps in feature_lists.items():
            inner = b"".join(_len_field(1, _encode_feature(s)) for s in steps)
            entry = _len_field(1, key.encode("utf-8")) + _len_field(2, inner)
            fl += _len_field(1, entry)
        out += _len_field(2, bytes(fl))
    return out


def write_tfrecord(path: str, records: list[bytes]) -> None:
    """Write framed records with valid masked CRC32Cs."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        for rec in records:
            header = struct.pack("<Q", len(rec))
            f.write(header)
            f.write(struct.pack("<I", masked_crc32c(header)))
            f.write(rec)
            f.write(struct.pack("<I", masked_crc32c(rec)))
